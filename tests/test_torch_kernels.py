"""Port kernels: the plain twins against ``repro``'s oracles and Pallas
kernels on the CPU, and (on a Hopper card only) the CUDA kernels against
their twins.

Inputs are seeded numpy arrays handed to both frameworks.  Contracts:
bitwise for rowmax, matvec_t (against ``repro``'s jnp ``x @ c``),
boost_scan, swap_eval and dual_step's ``g`` given the same ``x``; 1e-5
relative for matvec and dual_step's ``x`` (their K-long sums and ``pow``
round differently in XLA and PyTorch).  ``repro``'s Pallas ``boost_scan``
and ``swap_eval`` do not trace under the installed JAX (no ``pl.load``),
so those twins are checked against ``repro/kernels/ref.py`` alone.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import hotpath
from repro_torch.kernels import budget_alloc as ba
from repro_torch.kernels import ref

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:                              # pragma: no cover
    given = settings = st = None

# (M, K): paper-like, ragged, single row / column, wide
SHAPES_MK = [(6, 2000), (7, 1531), (1, 1), (5, 1), (3, 24), (13, 257)]
# (M, K) -> cs for rowmax / matvec: paper, FL e2e, large round, ragged,
# production, and one past the grid target
ROW_SPLITS = [((6, 2000), 1), ((2, 96), 1), ((32, 16384), 8),
              ((5, 53257), 8), ((1024, 131072), 1), ((300, 4099), 1)]
# (M, K) for the cluster kernels on the card: every cs (1, 2, 4, 8) and
# every K % 4
CLUSTER_SHAPES = [(1, 16384), (2, 16384), (32, 16384), (5, 53257),
                  (300, 4099), (1, 3), (3, 4097), (7, 8194), (7, 8195)]
# (N, K, C)
SHAPES_NKC = [(25, 200, 9), (7, 1531, 5), (1, 1, 1), (6, 24, 13)]
KAPPAS = [2.0, 1.25, 8.0]


@pytest.fixture(scope="module")
def jax_side():
    """``repro``'s oracles and Pallas kernels (imports JAX on demand, so the
    card-only tests below also collect where JAX is not installed)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import budget_alloc as jba
    from repro.kernels import ref as jref
    return jnp, jref, jba


@pytest.fixture
def hopper():
    """Skip unless an sm_90 card is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (compute capability 9.0)")
    return torch.device("cuda")


def _shares(rng, shape, density=0.5):
    """Demand-like nonnegative shares with zeros, float32."""
    g = rng.uniform(0, 0.1, shape) * (rng.random(shape) < density)
    return g.astype(np.float32)


def _mk_case(M, K, seed=0):
    rng = np.random.default_rng(seed)
    c = _shares(rng, (M, K))
    c[-1] = 0.0                                          # an all-zero row
    return dict(
        c=c, lam=rng.uniform(0.5, 2.0, K).astype(np.float32),
        x=rng.uniform(0.0, 2.0, M).astype(np.float32),
        w_pow=rng.uniform(0.5, 50.0, M).astype(np.float32),
        xcap=rng.uniform(1.0, 30.0, M).astype(np.float32),
        mask=np.arange(M) % 3 != 2,
        cap=rng.uniform(0.2, 1.0, K).astype(np.float32))


def _nkc_case(N, K, C, seed=0, M=None):
    rng = np.random.default_rng(seed)
    lead = () if M is None else (M,)
    g = _shares(rng, lead + (N, K), 0.3)
    g[..., 0, :] = 0.0                                   # a row with no demand
    sel = rng.random(lead + (N,)) < 0.6
    sel_c = rng.random(lead + (C, N)) < 0.5
    sel_c[..., 0, :] = False                             # a candidate with none
    return dict(g=g, sel=sel, sel_c=sel_c,
                left=rng.uniform(0.0, 0.4, lead + (K,)).astype(np.float32),
                left_c=rng.uniform(0.0, 0.4, lead + (C, K)).astype(
                    np.float32))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _rel_ok(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.all(np.abs(got - want) <= rtol * np.abs(want) + 1e-30)


# ---------------------------------------------------------------- CPU twins

@pytest.mark.parametrize("M,K", SHAPES_MK)
def test_rowmax_twin_bitwise(jax_side, M, K):
    jnp, jref, jba = jax_side
    d = _mk_case(M, K)
    got = ref.rowmax_ref(_t(d["c"])).numpy()
    np.testing.assert_array_equal(got, np.asarray(jref.rowmax_ref(d["c"])))
    pallas = jba.rowmax(jnp.asarray(d["c"]), block_m=M, block_k=K,
                        interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


@pytest.mark.parametrize("M,K", SHAPES_MK)
def test_matvec_twins(jax_side, M, K):
    jnp, jref, jba = jax_side
    d = _mk_case(M, K)
    c, lam, x = d["c"], d["lam"], d["x"]
    y = ref.matvec_ref(_t(c), _t(lam)).numpy()
    assert _rel_ok(y, jref.matvec_ref(c, lam))
    assert _rel_ok(y, jba.matvec(jnp.asarray(c), jnp.asarray(lam), block_m=M,
                                 block_k=K, interpret=True))
    load = ref.matvec_t_ref(_t(c), _t(x)).numpy()
    # repro's jnp hot path computes the load as ``x @ c``: rows in order,
    # one FMA each -- exactly the twin's rounding.
    np.testing.assert_array_equal(load, np.asarray(jnp.asarray(x) @ c))
    assert _rel_ok(load, jref.matvec_ref(c.T, x))


@pytest.mark.parametrize("M,K", SHAPES_MK)
@pytest.mark.parametrize("beta", [2.2, 0.5])
def test_dual_step_twin(jax_side, M, K, beta):
    jnp, jref, jba = jax_side
    d = _mk_case(M, K)
    cap_safe = np.maximum(d["cap"], 1e-12)
    args = (d["c"], d["lam"], d["w_pow"], d["xcap"], d["mask"], d["cap"],
            cap_safe)
    x, g = ref.dual_step_ref(*map(_t, args), beta)
    xj, gj = jref.dual_step_ref(*map(jnp.asarray, args), beta)
    assert _rel_ok(x.numpy(), xj)
    # g is bitwise given the same x
    g_at_xj = ref.dual_residual_ref(_t(d["c"]), _t(xj), _t(d["cap"]),
                                    _t(cap_safe))
    np.testing.assert_array_equal(g_at_xj.numpy(), np.asarray(gj))
    # ... and so against the Pallas kernel, at a tile that pads the rows
    xp, gp = jba.dual_step(*map(jnp.asarray, args), beta=beta,
                           block_m=max(1, M // 2), interpret=True)
    assert _rel_ok(x.numpy(), xp)
    g_at_xp = ref.dual_residual_ref(_t(d["c"]), _t(xp), _t(d["cap"]),
                                    _t(cap_safe))
    np.testing.assert_array_equal(g_at_xp.numpy(), np.asarray(gp))
    assert not x.numpy()[~d["mask"]].any()               # masked rows are 0


@pytest.mark.parametrize("N,K,C", SHAPES_NKC)
@pytest.mark.parametrize("kappa", KAPPAS)
def test_boost_scan_twin_bitwise(jax_side, N, K, C, kappa):
    jnp, jref, _ = jax_side
    d = _nkc_case(N, K, C)
    ex, left = ref.boost_scan_ref(_t(d["g"]), _t(d["sel"]), _t(d["left"]),
                                  kappa)
    exj, leftj = jref.boost_scan_ref(jnp.asarray(d["g"]),
                                     jnp.asarray(d["sel"]),
                                     jnp.asarray(d["left"]), kappa)
    np.testing.assert_array_equal(ex.numpy(), np.asarray(exj))
    np.testing.assert_array_equal(left.numpy(), np.asarray(leftj))
    assert not ex.numpy()[~d["sel"]].any()               # unselected: 0


@pytest.mark.parametrize("N,K,C", SHAPES_NKC)
@pytest.mark.parametrize("kappa", KAPPAS)
def test_swap_eval_twin_bitwise(jax_side, N, K, C, kappa):
    jnp, jref, _ = jax_side
    d = _nkc_case(N, K, C)
    ex = ref.swap_eval_ref(_t(d["g"]), _t(d["sel_c"]), _t(d["left_c"]),
                           kappa)
    exj = jref.swap_eval_ref(jnp.asarray(d["g"]), jnp.asarray(d["sel_c"]),
                             jnp.asarray(d["left_c"]), kappa)
    np.testing.assert_array_equal(ex.numpy(), np.asarray(exj))


def test_batched_sweeps_match_per_analyst(jax_side):
    """The analyst axis of the batched twins is a plain batch: each slice
    equals ``repro``'s unbatched oracle."""
    jnp, jref, _ = jax_side
    d = _nkc_case(9, 300, 7, M=4)
    ex, left = ref.boost_scan_ref(_t(d["g"]), _t(d["sel"]), _t(d["left"]),
                                  2.0)
    exc = ref.swap_eval_ref(_t(d["g"]), _t(d["sel_c"]), _t(d["left_c"]), 2.0)
    for m in range(4):
        exj, leftj = jref.boost_scan_ref(jnp.asarray(d["g"][m]),
                                         jnp.asarray(d["sel"][m]),
                                         jnp.asarray(d["left"][m]), 2.0)
        np.testing.assert_array_equal(ex[m].numpy(), np.asarray(exj))
        np.testing.assert_array_equal(left[m].numpy(), np.asarray(leftj))
        np.testing.assert_array_equal(
            exc[m].numpy(),
            np.asarray(jref.swap_eval_ref(jnp.asarray(d["g"][m]),
                                          jnp.asarray(d["sel_c"][m]),
                                          jnp.asarray(d["left_c"][m]), 2.0)))


def test_cpu_dispatch_runs_twins_and_counts_nothing():
    d = _mk_case(5, 40)
    b = _nkc_case(6, 40, 4, M=5)
    ba.reset_launches()
    c = _t(d["c"])
    assert torch.equal(hotpath.rowmax(c), ref.rowmax_ref(c))
    assert torch.equal(hotpath.matvec_t(c, _t(d["x"])),
                       ref.matvec_t_ref(c, _t(d["x"])))
    left, ex = hotpath.boost_scan(_t(b["g"]), _t(b["sel"]), _t(b["left"]),
                                  2.0)
    ex_r, left_r = ref.boost_scan_ref(_t(b["g"]), _t(b["sel"]),
                                      _t(b["left"]), 2.0)
    assert torch.equal(ex, ex_r) and torch.equal(left, left_r)
    assert torch.equal(
        hotpath.swap_eval(_t(b["g"]), _t(b["sel_c"]), _t(b["left_c"]), 2.0),
        ref.swap_eval_ref(_t(b["g"]), _t(b["sel_c"]), _t(b["left_c"]), 2.0))
    assert all(v == 0 for v in ba.LAUNCHES.values())


def test_wrappers_refuse_other_devices():
    """No fallback: a tensor on neither the CPU nor CUDA raises, and so do
    operands split across devices; the launchers take CUDA tensors only."""
    meta = torch.empty((3, 4), device="meta")
    with pytest.raises(ValueError):
        hotpath.rowmax(meta)
    with pytest.raises(ValueError):
        hotpath.matvec(meta, torch.ones(4))
    with pytest.raises(ValueError):
        ba.rowmax(torch.ones((3, 4)))
    assert all(v == 0 for v in ba.LAUNCHES.values())


# ------------------------------------------- row split (rowmax, matvec)

def _kernel_chunks(K, cs, head):
    """[start, end) of the row that each of the cs blocks reads, as
    ``row_chunk`` in csrc/budget_alloc.cu cuts it: ``head`` scalars up to
    the row's first 16-byte boundary (block 0), the float4 body in cs
    balanced runs, the scalar tail (block cs - 1)."""
    h = min(head, K)
    nvec = (K - h) // 4
    cuts = [h + 4 * (r * nvec // cs) for r in range(1, cs)]
    return list(zip([0] + cuts, cuts + [K]))


@pytest.mark.parametrize("MK,cs", ROW_SPLITS)
def test_row_split_at_the_main_path_shapes(MK, cs):
    assert ba.row_split(*MK) == cs


def _check_row_split(M, K, head):
    cs = ba.row_split(M, K)
    assert cs in (1, 2, 4, 8)
    if M >= ba.ROW_SPLIT_BLOCKS or K < 2 * ba.ROW_SPLIT_MIN_CHUNK:
        assert cs == 1
    # the split stops only at the cluster limit, the grid target or the
    # chunk minimum
    assert (cs == ba.ROW_SPLIT_MAX or cs * M >= ba.ROW_SPLIT_BLOCKS
            or K < 2 * cs * ba.ROW_SPLIT_MIN_CHUNK)
    chunks = _kernel_chunks(K, cs, head)
    assert len(chunks) == cs and chunks[0][0] == 0 and chunks[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all((lo - min(head, K)) % 4 == 0 for lo, _ in chunks[1:])
    if cs > 1:
        # a boundary on the row's 16-byte grid moves by up to 3 floats
        least = ba.ROW_SPLIT_MIN_CHUNK - (0 if head == 0 else 4)
        assert min(hi - lo for lo, hi in chunks) >= least


if given is not None:
    @settings(max_examples=400, deadline=None)
    @given(M=st.integers(1, 4096), K=st.integers(1, 1 << 20),
           head=st.integers(0, 3))
    def test_row_split_property(M, K, head):
        """cs is a portable cluster size, 1 for many rows or short ones;
        the kernel's chunks cover the row exactly, none under the
        minimum (less a misaligned row's shift) unless cs = 1."""
        _check_row_split(M, K, head)


@pytest.mark.parametrize("M,K", [(1, 4095), (1, 4096), (131, 8191),
                                 (132, 8192), (263, 1 << 20),
                                 (264, 1 << 20), (1, 1 << 20)])
@pytest.mark.parametrize("head", [0, 1, 3])
def test_row_split_edges(M, K, head):
    _check_row_split(M, K, head)


# ------------------------------------------- sweep split (boost sweeps)

# (M, C, K) -> (cs, T): paper swap_eval / boost_scan, large, ragged, the
# beam's few candidates, and a K whose stripes stay in device memory
SWEEP_SPLITS = [((6, 156, 2000), (1, 2)), ((6, 1, 2000), (1, 1)),
                ((32, 256, 16384), (8, 4)), ((32, 1, 16384), (8, 1)),
                ((5, 11, 53257), (8, 1)), ((5, 1, 53257), (8, 1)),
                ((32, 8, 16384), (8, 4)), ((1, 2, 450_000), (8, 1))]


@pytest.mark.parametrize("MCK,geo", SWEEP_SPLITS)
def test_sweep_split_at_the_main_path_shapes(MCK, geo):
    assert ba.sweep_split(*MCK) == geo
    M, C, K = MCK
    spills = ba.sweep_smem(K, *geo) > ba.SWEEP_SMEM_MAX
    assert spills == (K == 450_000)          # only the spill shape spills


def test_sweep_smem_counts_stripes_and_lists():
    """T stripes of 4 * ceil(ceil(K / 4) / cs) floats, and 8 warps' lists
    of 128 * V eight-byte pairs, V = 2 up to 2048-float stripes, else 8."""
    assert ba.sweep_smem(16384, 8, 8) == 8 * 2048 * 4 + 8 * 128 * 2 * 8
    assert ba.sweep_smem(2000, 1, 2) == 2 * 2000 * 4 + 8 * 128 * 2 * 8
    assert ba.sweep_smem(53257, 8, 1) == 6660 * 4 + 8 * 128 * 8 * 8
    assert ba.sweep_smem(2049, 1, 1) == 2052 * 4 + 8 * 128 * 8 * 8
    # the spill boundary at T = 1, cs = 8: 136 KB of stripe with the lists
    assert ba.sweep_smem(278_528, 8, 1) == ba.SWEEP_SMEM_MAX
    assert ba.sweep_smem(278_529, 8, 1) > ba.SWEEP_SMEM_MAX


def _check_sweep_split(M, C, K):
    cs, T = ba.sweep_split(M, C, K)
    assert cs in (1, 2, 4, 8) and 1 <= T <= min(max(C, 1), ba.SWEEP_TILE_MAX)
    if C == 1:
        assert T == 1                        # boost_scan
    if cs > 1:                               # stripes keep 2048 floats
        assert K >= cs * ba.ROW_SPLIT_MIN_CHUNK
    can_split = cs < ba.ROW_SPLIT_MAX and K >= 2 * cs * ba.ROW_SPLIT_MIN_CHUNK
    # a block over its target, or a grid under two blocks an SM, only
    # where neither cs nor T can move further
    if ba.sweep_smem(K, cs, T) > ba.SWEEP_SMEM_TARGET:
        assert not can_split and T == 1
    if M * -(-C // T) * cs < ba.ROW_SPLIT_BLOCKS:
        assert not can_split and T == 1
    # within the hard limit unless even T = 1 on a full cluster is over it
    if ba.sweep_smem(K, cs, T) > ba.SWEEP_SMEM_MAX:
        assert T == 1 and not can_split


@pytest.mark.parametrize("M,C,K", [(1, 1, 1), (1, 9, 4095), (1, 9, 4096),
                                   (264, 1, 1 << 20), (33, 8, 16384),
                                   (7, 300, 7), (2, 3, 278_529),
                                   (1024, 256, 131072)])
def test_sweep_split_edges(M, C, K):
    _check_sweep_split(M, C, K)


if given is not None:
    @settings(max_examples=400, deadline=None)
    @given(M=st.integers(1, 2048), C=st.integers(1, 512),
           K=st.integers(1, 1 << 20))
    def test_sweep_split_property(M, C, K):
        """cs a portable cluster size, T within the tile limit and C, the
        block within its target and the grid at two blocks an SM wherever
        cs or T could still move."""
        _check_sweep_split(M, C, K)


# ------------------------------------------------ CUDA kernels (card only)

def _dev(d, dev):
    out = {}
    for k, v in d.items():
        t = torch.as_tensor(np.asarray(v))
        out[k] = (t.to(torch.int32) if t.dtype == torch.bool else t).to(dev)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("M,K", SHAPES_MK)
def test_cuda_dense_kernels_match_twins(hopper, M, K):
    d = _dev(_mk_case(M, K), hopper)
    ba.reset_launches()
    c = d["c"]
    assert torch.equal(ba.rowmax(c), ref.rowmax_ref(c))
    assert _rel_ok(ba.matvec(c, d["lam"]).cpu(),
                   ref.matvec_ref(c, d["lam"]).cpu())
    assert _rel_ok(ba.matvec_t(c, d["x"]).cpu(),
                   ref.matvec_t_ref(c, d["x"]).cpu())
    cap_safe = torch.clamp(d["cap"], min=1e-12)
    x, g = ba.dual_step(c, d["lam"], d["w_pow"], d["xcap"], d["mask"],
                        d["cap"], cap_safe, 2.2)
    xr, _ = ref.dual_step_ref(c, d["lam"], d["w_pow"], d["xcap"], d["mask"],
                              d["cap"], cap_safe, 2.2)
    assert _rel_ok(x.cpu(), xr.cpu())
    assert torch.equal(g, ref.dual_residual_ref(c, x, d["cap"], cap_safe))
    assert ba.LAUNCHES == dict(rowmax=1, matvec=1, matvec_t=1, dual_step=1,
                               boost_scan=0, swap_eval=0)


# (M, N, K, C, (cs, T) forced, or None for sweep_split's own): the CPU
# shapes, cs 1 to 8, C not a multiple of T, 16-byte and 4-byte loads (K % 4),
# stripes of several chunks, the shared-memory boundary at T = 1 and the
# spill path (stripes past 8 x 200 KB stay in device memory)
SWEEP_CASES = ([(3, N, K, C, None) for N, K, C in SHAPES_NKC]
               + [(3, 9, 4096, 13, (1, 8)), (3, 9, 16384, 13, (8, 4)),
                  (3, 9, 16411, 13, (8, 8)), (2, 7, 9001, 5, (2, 2)),
                  (2, 7, 4093, 3, (4, 1)), (2, 5, 53257, 3, (1, 1)),
                  (5, 7, 53257, 11, None), (1, 3, 278_528, 1, None),
                  (1, 3, 278_529, 1, None), (1, 3, 450_000, 2, None)])


def _sweep_case(M, N, K, C, seed=0):
    """_nkc_case with a visit that no candidate selects (visit 1) and
    negative leftovers, as infeasible candidates have."""
    d = _nkc_case(N, K, C, seed, M=M)
    if N > 1:
        d["sel_c"][:, :, 1] = False
        d["sel"][:, 1] = False
    d["left_c"][:, 1::3] -= 0.3
    d["left"][0] -= 0.3
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K,C,geo", SWEEP_CASES)
def test_cuda_boost_sweeps_match_twins_bitwise(hopper, monkeypatch, M, N, K,
                                               C, geo):
    """boost_scan's extras and leftover and swap_eval's extras equal the
    twins' bit for bit at every geometry, and from launch to launch; an
    all-zero demand row and a candidate that selects nothing included."""
    if geo is not None:
        monkeypatch.setattr(ba, "sweep_split",
                            lambda m, c, k: (geo[0], min(geo[1], c)))
    d = _dev(_sweep_case(M, N, K, C), hopper)
    ba.reset_launches()
    runs = [ba.boost_scan(d["g"], d["sel"], d["left"], 2.0) for _ in "ab"]
    ex_r, left_r = ref.boost_scan_ref(d["g"], d["sel"], d["left"], 2.0)
    for ex, left in runs:
        assert torch.equal(ex.view(torch.int32), ex_r.view(torch.int32))
        assert torch.equal(left.view(torch.int32), left_r.view(torch.int32))
    cs, T = ba.sweep_split(M, 1, K)
    assert ba.LAST_GRID["boost_sweep"] == (cs, 1, M * cs)
    sw = [ba.swap_eval(d["g"], d["sel_c"], d["left_c"], 2.0) for _ in "ab"]
    sw_r = ref.swap_eval_ref(d["g"], d["sel_c"], d["left_c"], 2.0)
    for ex in sw:
        assert torch.equal(ex.view(torch.int32), sw_r.view(torch.int32))
    cs, T = ba.sweep_split(M, C, K)
    assert ba.LAST_GRID["boost_sweep"] == (cs, T, M * -(-C // T) * cs)
    assert ba.LAST_GRID["swap_eval"] == (M, C)
    assert ba.LAUNCHES["boost_scan"] == 2 and ba.LAUNCHES["swap_eval"] == 2


@pytest.mark.cuda
def test_cuda_refused_sweep_launch_raises(hopper, monkeypatch):
    """A geometry the kernel does not take (a cluster of 3, a tile of 9)
    returns a nonzero cudaError_t and raises; nothing falls back or
    counts.  The launcher's shared-memory limit is the package's."""
    assert ba._lib().ba_boost_smem_limit() == ba.SWEEP_SMEM_MAX
    d = _dev(_sweep_case(2, 5, 4096, 9), hopper)
    ba.reset_launches()
    for geo in ((3, 1), (1, 9)):
        monkeypatch.setattr(ba, "sweep_split", lambda m, c, k: geo)
        with pytest.raises(RuntimeError, match="ba_boost_sweep"):
            ba.swap_eval(d["g"], d["sel_c"], d["left_c"], 2.0)
    assert ba.LAUNCHES["swap_eval"] == 0 and "boost_sweep" not in ba.LAST_GRID


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(hopper):
    c = torch.ones((4, 8), device=hopper)
    with pytest.raises(TypeError):
        ba.rowmax(c.double())
    with pytest.raises(ValueError):
        ba.rowmax(c.T)                                   # not contiguous
    with pytest.raises(ValueError):
        ba.matvec(c, torch.ones(8))                      # mixed devices
    with pytest.raises(TypeError):
        ba.swap_eval(torch.ones((1, 2, 8), device=hopper),
                     torch.ones((1, 3, 2), device=hopper),   # float sel
                     torch.ones((1, 3, 8), device=hopper), 2.0)


def _misaligned(a, off, dev):
    """``a`` (numpy float32) on ``dev`` as a contiguous view starting
    ``off`` floats past the allocation's start, so its rows start at every
    16-byte phase."""
    flat = torch.zeros(a.size + off, dtype=torch.float32, device=dev)
    flat[off:] = torch.as_tensor(a.ravel(), device=dev)
    return flat[off:].view(a.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K", CLUSTER_SHAPES + SHAPES_MK)
@pytest.mark.parametrize("off", [0, 1, 2, 3])
def test_cuda_cluster_kernels_match_twins(hopper, M, K, off):
    """rowmax bitwise with its twin, matvec within 1e-5 relative and
    bitwise from launch to launch, at every cs and row alignment (c and v
    at different 16-byte phases when off > 0)."""
    rng = np.random.default_rng(M * 100003 + K)
    c = _shares(rng, (M, K))
    lam = rng.uniform(0.5, 2.0, K).astype(np.float32)
    cd = _misaligned(c, off, hopper)
    vd = _misaligned(lam, (off + 1) % 4 if off else 0, hopper)
    ba.reset_launches()
    mu = ba.rowmax(cd)
    assert torch.equal(mu.view(torch.int32),
                       ref.rowmax_ref(cd).view(torch.int32))
    y = ba.matvec(cd, vd)
    assert _rel_ok(y.cpu(), ref.matvec_ref(cd, vd).cpu())
    assert torch.equal(y.view(torch.int32),
                       ba.matvec(cd, vd).view(torch.int32))
    cs = ba.row_split(M, K)
    assert ba.LAST_GRID["rowmax"] == (cs, M)
    assert ba.LAST_GRID["matvec"] == (cs, M)
    assert ba.LAUNCHES["rowmax"] == 1 and ba.LAUNCHES["matvec"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("M,K", [(4, 16384), (4, 53257), (4, 2000)])
def test_cuda_cluster_kernels_on_signed_and_zero_rows(hopper, M, K):
    """An all-zero row, an all-negative row, a row of -0.0 and negatives
    (max -0.0) and a row of -0.0 and positives: rowmax bitwise, sign of
    zero included; matvec within 1e-5 relative."""
    rng = np.random.default_rng(K)
    c = np.zeros((M, K), np.float32)
    c[1] = -rng.uniform(0.01, 1.0, K)
    c[2] = -rng.uniform(0.01, 1.0, K)
    c[2, ::7] = -0.0
    c[3] = rng.uniform(0.0, 1.0, K) * (rng.random(K) < 0.01)
    c[3, rng.random(K) < 0.5] = -0.0
    lam = rng.uniform(-1.0, 1.0, K).astype(np.float32)
    cd = torch.as_tensor(c, device=hopper)
    vd = torch.as_tensor(lam, device=hopper)
    mu = ba.rowmax(cd)
    assert torch.equal(mu.view(torch.int32),
                       ref.rowmax_ref(cd).view(torch.int32))
    assert float(mu[2]) == 0.0 and torch.signbit(mu[2])
    assert _rel_ok(ba.matvec(cd, vd).cpu(), ref.matvec_ref(cd, vd).cpu())


@pytest.mark.cuda
def test_cuda_refused_cluster_launch_raises(hopper, monkeypatch):
    """A cluster size the card does not take reaches the launcher as a
    nonzero cudaError_t and raises; nothing falls back or counts."""
    c = torch.ones((4, 8192), device=hopper)
    ba.reset_launches()
    monkeypatch.setattr(ba, "row_split", lambda M, K: 3)
    with pytest.raises(RuntimeError, match="ba_rowmax"):
        ba.rowmax(c)
    with pytest.raises(RuntimeError, match="ba_matvec"):
        ba.matvec(c, torch.ones(8192, device=hopper))
    assert ba.LAUNCHES["rowmax"] == 0 and ba.LAUNCHES["matvec"] == 0
    assert "rowmax" not in ba.LAST_GRID


def _oracle_problem(seed, N, K=12):
    rng = np.random.default_rng(seed)
    g = (rng.uniform(0, 0.4, (N, K)) * (rng.random((N, K)) < 0.5)
         ).astype(np.float32)
    a = rng.uniform(0.3, 1.0, N).astype(np.float32)
    act = rng.random(N) < 0.9
    return g, g.max(-1), a, act, (g.sum(0) * 0.4).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,N", [(0, 6), (3, 10)])
def test_cuda_exact_pack_sweeps_on_the_card(hopper, seed, N):
    """``exact_pack``'s boost sweep launches ``boost_scan`` on the card by
    default and picks the subset, count and objective the CPU picks."""
    from repro_torch.core import packing
    args = _oracle_problem(seed, N)
    cs, cc, co = packing.exact_pack(*args, 2.0, device="cpu")
    ba.reset_launches()
    ks, kc, ko = packing.exact_pack(*args, 2.0)
    assert ba.LAUNCHES["boost_scan"] >= 1
    np.testing.assert_array_equal(ks, cs)
    assert (kc, ko) == (cc, co)


@pytest.mark.cuda
@pytest.mark.parametrize("levels,k", [(2, 8), (4, 9), (50, 8)])
def test_cuda_top_k_ties_to_the_lowest_index(hopper, levels, k):
    """The swap beam's top-k on the card: equal to a stable descending
    sort's first ``k`` (values and indices) on rows dense with ties."""
    from repro_torch.core import swap
    rng = np.random.default_rng(levels * 10 + k)
    x = rng.integers(0, levels, (3, 40, 5000)).astype(np.float32)
    x[x == 0] = -np.inf
    xd = torch.as_tensor(x, device=hopper)
    v, i = swap._top_k(xd, k)
    sv, si = torch.sort(xd, dim=-1, descending=True, stable=True)
    assert torch.equal(v, sv[..., :k]) and torch.equal(i, si[..., :k])
