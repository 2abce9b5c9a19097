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
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import rg_lru
from repro_torch.kernels.decode_attention import SMS

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


@pytest.mark.parametrize("S,D", [(1, 8), (64, 40), (300, 7)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_twin_backward_matches_jax_grad_of_linear_scan(jax_side, S, D,
                                                       with_h0):
    """``_TwinScan``'s gradients (the contract of the card's backward
    kernel) within 1e-5 of the largest |g| of ``jax.grad`` through
    ``repro``'s associative ``linear_scan``: one step, a multiple of the
    kernel's 16 steps ahead, a long ragged scan."""
    jax, _, _, JR = jax_side
    a, b, h0 = _abh(3, S, D, seed=S * D)
    h0 = h0 if with_h0 else None
    w = np.random.default_rng(S).standard_normal((3, S, D)).astype(
        np.float32)
    argn = (0, 1, 2) if with_h0 else (0, 1)
    want = jax.jit(jax.grad(
        lambda a, b, h0: (JR.linear_scan(a, b, h0) * w).sum(),
        argnums=argn))(a, b, h0)
    ta, tb, th = (None if x is None else x.requires_grad_()
                  for x in _t(a, b, h0))
    h = rg_lru._TwinScan.apply(ta, tb, th)
    h.backward(torch.from_numpy(w))
    for g, wg in zip((ta.grad, tb.grad) + ((th.grad,) if with_h0 else ()),
                     want):
        wg = np.asarray(wg)
        assert np.abs(g.numpy() - wg).max() <= 1e-5 * np.abs(wg).max()


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
    """Off the CPU there is no twin backward: a tensor that needs a
    gradient goes to the kernel's autograd function and one that does not
    to the launcher; both take CUDA tensors only and raise before any
    launch (meta tensors stand in for the card's here)."""
    a = torch.empty((1, 4, 8), device="meta", requires_grad=True)
    b = torch.empty((1, 4, 8), device="meta")
    rg_lru.reset_launches()
    with pytest.raises(ValueError, match="no Hopper kernel"):
        rg_lru.rglru_scan(a, b)
    with torch.no_grad(), pytest.raises(ValueError):
        rg_lru.rglru_scan(a, b)
    with pytest.raises(ValueError, match="no Hopper kernel"):
        rg_lru.rglru_scan_bwd_cuda(a.detach(), b, b)
    assert rg_lru.LAUNCHES == {"rglru_scan": 0}
    assert rg_lru.BWD_LAUNCHES == {"rglru_scan_bwd": 0}


# ------------------------------------------------------- the ring's geometry
# (B, S, D): recurrentgemma-2b's prefills (default, long, one sequence),
# its decode step, chip_smoke.py's ragged shape, the ring's edges around
# S = 32 and 64, a narrow D with a long S, a wide batch
GEO_SHAPES = [(4, 32, 2560), (4, 2048, 2560), (1, 2048, 2560), (4, 1, 2560),
              (3, 1000, 2597), (4, 31, 2560), (4, 63, 2560), (4, 65, 2560),
              (2, 37, 100), (1, 5000, 7), (64, 2048, 2560), (1, 100000, 1)]


@pytest.mark.parametrize("B,S,D", GEO_SHAPES)
def test_scan_geometry_keeps_its_invariants(B, S, D):
    """The stages in flight hold SCAN_IN_FLIGHT bytes unless a cap binds,
    and no shallower stage would; a block's ring fits the card's shared
    memory; the ring never exceeds S; a stage is a multiple of SCAN_STEP;
    S < 32 and D % 4 != 0 take the direct path."""
    stage = rg_lru.scan_geometry(B, S, D)
    assert stage % rg_lru.SCAN_STEP == 0 and 0 <= stage
    assert rg_lru.SCAN_STAGES * stage <= S
    assert (stage == 0) == (S < rg_lru.SCAN_STAGES * rg_lru.SCAN_STEP
                            or D % 4 != 0)
    assert rg_lru.scan_smem(stage) <= rg_lru.SMEM_MAX
    if stage:
        fit = S // rg_lru.SCAN_STAGES // rg_lru.SCAN_STEP * rg_lru.SCAN_STEP
        ahead = (rg_lru.SCAN_STAGES - 1) * 8 * B * D
        assert ahead * stage >= rg_lru.SCAN_IN_FLIGHT or \
            stage in (rg_lru.SCAN_STAGE_MAX, fit)
        assert stage <= rg_lru.SCAN_STEP or \
            ahead * (stage - rg_lru.SCAN_STEP) < rg_lru.SCAN_IN_FLIGHT


def test_scan_smem_fits_at_every_stage():
    for stage in range(0, rg_lru.SCAN_STAGE_MAX + 1, rg_lru.SCAN_STEP):
        assert rg_lru.scan_smem(stage) <= rg_lru.SMEM_MAX


# (B, S, D) -> (stage, ring, bytes in flight, most channels on an SM)
GEO_PINS = {(4, 2048, 2560): (16, 64, 3_932_160, 128),
            (1, 2048, 2560): (48, 192, 2_949_120, 64),
            (3, 1000, 2597): (0, 0, 0, 64),
            (4, 32, 2560): (8, 32, 1_966_080, 128),
            (4, 1, 2560): (0, 0, 0, 128)}


@pytest.mark.parametrize("shape", sorted(GEO_PINS))
def test_scan_geometry_at_the_serve_shapes(shape):
    """chip_smoke.py's shapes: 3.9 MB in flight at B*D = 10,240 (a ring
    of 64 steps), the largest stage at 2,560, the direct path at S = 1
    and at the ragged D; 160 blocks of 64 channels at most 128 to an SM
    against a mean of 77.6 (32-channel blocks would put 96; on the card
    they tie, PERF.md)."""
    B, S, D = shape
    stage = rg_lru.scan_geometry(B, S, D)
    ch = rg_lru.SCAN_CHANNELS
    got = (stage, rg_lru.SCAN_STAGES * stage,
           (rg_lru.SCAN_STAGES - 1) * stage * 8 * B * D,
           -(-B * -(-D // ch) // SMS) * ch)
    assert got == GEO_PINS[shape]
    if shape == (4, 2048, 2560):
        assert -(-B * D // 32 // SMS) * 32 == 96


def test_scan_constants_mirror_the_source():
    """The launcher's ring constants are the source's."""
    src = (build.CSRC / "rg_lru.cu").read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+);", src).group(1))
    assert (const("kStages"), const("kStep"), const("kStageMax"),
            const("kChannels")) == (
        rg_lru.SCAN_STAGES, rg_lru.SCAN_STEP, rg_lru.SCAN_STAGE_MAX,
        rg_lru.SCAN_CHANNELS)


def test_scan_mode_by_alignment():
    """The ring where D % 4 == 0 and every operand is 16-byte aligned;
    the direct path otherwise."""
    buf = torch.zeros(4 * 8 * 12 + 1)
    a, off = buf[:-1].view(4, 8, 12), buf[1:].view(4, 8, 12)
    assert rg_lru.ring_takes(a, a)
    assert not rg_lru.ring_takes(a, off)
    assert rg_lru.scan_geometry(4, 800, 12) > 0
    assert rg_lru.scan_geometry(4, 800, 13) == 0


# ------------------------------------------------- the gradient's geometry
# GEO_SHAPES and the training microbatch's shape (chip_smoke.py RG_TRAIN)
BWD_GEO_SHAPES = GEO_SHAPES + [(2, 128, 2560)]


@pytest.mark.parametrize("B,S,D", BWD_GEO_SHAPES)
def test_scan_bwd_geometry_keeps_its_invariants(B, S, D):
    """The stages in flight hold at most SCAN_BWD_IN_FLIGHT bytes of a,
    dL/dh and h unless the stage is SCAN_STEP, and the next larger stage
    would hold more unless a cap binds; a block's rings fit the card's
    shared memory; the ring never exceeds S; a stage is a multiple of
    SCAN_STEP; S < 32 and D % 4 != 0 take the direct path."""
    stage = rg_lru.scan_bwd_geometry(B, S, D)
    assert stage % rg_lru.SCAN_STEP == 0 and 0 <= stage
    assert rg_lru.SCAN_STAGES * stage <= S
    assert (stage == 0) == (S < rg_lru.SCAN_STAGES * rg_lru.SCAN_STEP
                            or D % 4 != 0)
    assert rg_lru.scan_bwd_smem(stage) <= rg_lru.SMEM_MAX
    if stage:
        fit = S // rg_lru.SCAN_STAGES // rg_lru.SCAN_STEP * rg_lru.SCAN_STEP
        ahead = (rg_lru.SCAN_STAGES - 1) * 12 * B * D
        assert ahead * stage <= rg_lru.SCAN_BWD_IN_FLIGHT or \
            stage == rg_lru.SCAN_STEP
        assert ahead * (stage + rg_lru.SCAN_STEP) > \
            rg_lru.SCAN_BWD_IN_FLIGHT or \
            stage in (rg_lru.SCAN_STAGE_MAX, fit)


def test_scan_bwd_smem_fits_at_every_stage():
    """Every stage the C entry takes fits a block of the card's shared
    memory, two blocks an SM at the largest."""
    for stage in range(0, rg_lru.SCAN_STAGE_MAX + 1, rg_lru.SCAN_STEP):
        assert rg_lru.scan_bwd_smem(stage) <= rg_lru.SMEM_MAX
    assert 2 * rg_lru.scan_bwd_smem(rg_lru.SCAN_STAGE_MAX) <= \
        rg_lru.SMEM_MAX
    assert rg_lru.scan_bwd_smem(48) == 98_336


# chip_smoke.py's RG_BWD_CASES: (B, S, D) -> (stage, ring, bytes in
# flight, blocks of the kernel that runs)
BWD_GEO_PINS = {(4, 2048, 2560): (8, 32, 2_949_120, 320),
                (1, 2048, 2560): (48, 192, 4_423_680, 80),
                (3, 1000, 2597): (0, 0, 0, 123),
                (2, 128, 2560): (24, 96, 4_423_680, 160),
                (2, 1000, 2560): (24, 96, 4_423_680, 160)}


@pytest.mark.parametrize("shape", sorted(BWD_GEO_PINS))
def test_scan_bwd_geometry_at_the_smoke_shapes(shape):
    """The stage, ring, bytes in flight and blocks at chip_smoke.py's
    backward shapes: the stage the card measured fastest at each B*D
    (PERF.md) -- 8 steps at 10,240 (16 held 5.9 MB and lost), 24
    at 5,120 (the training microbatch's 128 steps: the first stage runs
    16 steps past S), the largest at 2,560 on 80 blocks of 32 channels
    (one an SM); the ragged D on the direct path's 64-channel blocks."""
    B, S, D = shape
    stage = rg_lru.scan_bwd_geometry(B, S, D)
    ch = rg_lru.SCAN_BWD_CHANNELS if stage else rg_lru.SCAN_CHANNELS
    got = (stage, rg_lru.SCAN_STAGES * stage,
           (rg_lru.SCAN_STAGES - 1) * stage * 12 * B * D, B * -(-D // ch))
    assert got == BWD_GEO_PINS[shape]


def test_scan_bwd_constants_mirror_the_source():
    """The gradient's block and shared memory rule are the source's."""
    src = (build.CSRC / "rg_lru.cu").read_text()
    assert int(re.search(r"\bkBwdChannels = (\d+);", src).group(1)) == \
        rg_lru.SCAN_BWD_CHANNELS
    assert "(3 * kStages + 4) * stage * 32" in src
    assert "rg_scan_bwd_at" in build.SIGNATURES["rg_lru"]


def test_scan_bwd_mode_by_alignment():
    """The gradient's ring where D % 4 == 0 and every operand is 16-byte
    aligned; the direct path otherwise."""
    buf = torch.zeros(4 * 800 * 12 + 1)
    a, off = buf[:-1].view(4, 800, 12), buf[1:].view(4, 800, 12)
    assert rg_lru.ring_takes(a, a, a, a, a)
    assert not rg_lru.ring_takes(a, a, off, a, a)
    assert rg_lru.scan_bwd_geometry(4, 800, 12) > 0
    assert rg_lru.scan_bwd_geometry(4, 800, 13) == 0
    assert rg_lru.scan_bwd_geometry(4, 31, 12) == 0


# ------------------------------------------------------------ on the card
# (B, S, D, with h0, forced stage or None for scan_geometry's): ragged S
# and D, the decode shape (S = 1), the serve's widths; S one below, at and
# one above the ring of 64 steps at B*D = 10,240, one below and above the
# ring of 192 at 2,560; one sequence's long prefill; a D below one warp
# with a long S; S smaller than one stage, S not a multiple of the stage,
# D not a multiple of the block, the largest stage, the direct path at a
# long S
CARD_SCAN = [(3, 1000, 2560 + 37, True, None), (2, 37, 100, False, None),
             (4, 1, 2560, True, None), (1, 1, 7, False, None),
             (4, 32, 2560, False, None), (2, 17, 64, True, None),
             (4, 63, 2560, True, None), (4, 64, 2560, False, None),
             (4, 65, 2560, True, None), (1, 191, 2560, False, None),
             (1, 193, 2560, True, None), (1, 2048, 2560, False, None),
             (1, 300, 7, True, None), (2, 5, 100, True, 8),
             (3, 37, 100, False, 16), (1, 333, 2596, True, 48),
             (2, 200, 96, True, 8), (2, 100, 64, True, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,with_h0,stage", CARD_SCAN)
def test_cuda_scan_is_bitwise_the_twin(hopper, monkeypatch, B, S, D, with_h0,
                                       stage):
    if stage is not None:
        monkeypatch.setattr(rg_lru, "scan_geometry", lambda B, S, D: stage)
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
def test_cuda_scan_takes_operands_off_16_byte_alignment(hopper):
    """Views one float into larger buffers: 4-byte but not 16-byte aligned
    a, b and h0, D a multiple of 4, so the direct path; bitwise the twin,
    one launch a call."""
    B, S, D = 2, 130, 256
    x = _t(*_abh(B, S, D, seed=9))
    a, b, h0 = (torch.cat([torch.zeros(1), t.flatten()]).to(hopper)[1:]
                .view(t.shape) for t in x)
    assert all(t.data_ptr() % 16 == 4 for t in (a, b, h0))
    assert rg_lru.scan_geometry(B, S, D) > 0 and not rg_lru.ring_takes(a, b)
    rg_lru.reset_launches()
    got = rg_lru.rglru_scan_cuda(a, b, h0)
    assert torch.equal(got, ref.rglru_scan_ref(a, b, h0))
    assert torch.equal(got, rg_lru.rglru_scan_cuda(a, b, h0))
    assert rg_lru.LAUNCHES == {"rglru_scan": 2}


@pytest.mark.cuda
def test_cuda_scan_rejects_what_the_kernel_does_not_take(hopper,
                                                          monkeypatch):
    a, b, h0 = (x.to(hopper) for x in _t(*_abh(2, 8, 16)))
    with pytest.raises(TypeError):
        rg_lru.rglru_scan_cuda(a.double(), b, h0)
    with pytest.raises(ValueError):
        rg_lru.rglru_scan_cuda(a.transpose(1, 2), b, h0)  # not contiguous
    with pytest.raises(ValueError):
        rg_lru.rglru_scan_cuda(a, b, h0.cpu())            # mixed devices
    with pytest.raises(ValueError):
        rg_lru.rglru_scan_cuda(a, b, h0[:1])              # wrong h0 shape
    with pytest.raises(TypeError):
        rg_lru.rglru_scan_bwd_cuda(a, b, b.double(), h0)  # grad_h's dtype
    big = torch.zeros((65536, 1, 1), device=hopper)
    with pytest.raises(ValueError):
        rg_lru.rglru_scan_cuda(big, big)                  # past the grid
    rg_lru.reset_launches()
    for stage in (4, 56, -8):                             # refused: raises
        monkeypatch.setattr(rg_lru, "scan_geometry", lambda B, S, D: stage)
        with pytest.raises(RuntimeError, match="rg_scan"):
            rg_lru.rglru_scan_cuda(a.detach(), b, h0)
    assert rg_lru.LAUNCHES == {"rglru_scan": 0}
    # a ring over operands the tensor maps do not take
    buf = torch.zeros(a.numel() + 1, device=hopper)
    off, h = buf[1:].view(a.shape), torch.empty_like(a)
    assert build.library("rg_lru").rg_scan_at(
        off.data_ptr(), off.data_ptr(), None, h.data_ptr(), *a.shape, 8,
        torch.cuda.current_stream().cuda_stream) != 0
