"""The mixture-of-experts block (``repro_torch.models.moe``) against
``repro/models/moe.py`` on the CPU.

Geometries (experts, top k): 4 over 2, mixtral-8x22b's 8 over 2 and
kimi-k2-1t-a32b's 384 over 8, at a narrow width (D 32, F 24, 64 tokens);
SwiGLU (``w_gate``) and tanh-GELU experts; one dispatch group and two; a
router left as drawn and one biased so that a single expert is every
token's first choice and overflows its capacity.  Parameters are
``repro``'s ``init_moe`` in float32 (banks ``N(0, 1/E)``), inputs seeded
numpy.  Tolerances: outputs within 1e-5 of the largest |out|; gradients
(input and every leaf, against ``jax.grad``) within 1e-4 of each one's
largest |g|; the chosen experts, each slot's assignment and which slots
are valid (the dropped assignments) equal to ``repro``'s, computed with
``repro``'s own operations (``jax.lax.top_k``, ``jnp.argsort``,
``bincount``, the sentinel-padded slice) on its logits.  Where the k-th
and (k+1)-th logits of a token lie within 1e-5 of its largest |logit|,
the two sides may choose differently: such near-ties are counted, their
tokens left out of the experts' comparison, and the counts pinned in
NEAR_TIES (one token of kimi's biased input, 384 experts: its 8th and
9th logits are 7.6e-6 of its largest apart; on the CPU both sides'
logits are bitwise equal, so its routing agrees too and the slot
comparisons need no exclusion).
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.models import moe as M

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.models import moe as JM  # noqa: E402

D, F, T = 32, 24, 64
GEOMETRIES = {"e4k2": (4, 2), "mixtral": (8, 2), "kimi": (384, 8)}
BIASED = 3                       # the expert the biased router favours
# (geometry, biased, group of 2) -> near-tie tokens of that group's logits
NEAR_TIES = {("kimi", True, 0): 1}


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


def _params(E, act, seed=0):
    tree = JM.init_moe(jax.random.PRNGKey(seed), D, F, E, act,
                       dtype=jnp.float32)
    return {k: np.array(v, np.float32) for k, v in tree.items()}


def _inputs(E, biased, seed=1):
    """x [T, D] 0.5 N(0, 1); biased: column 0 near 1 and the router's row
    0 steering it to expert BIASED."""
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((T, D))).astype(np.float32)
    if biased:
        x[:, 0] = 1.0 + 0.05 * rng.standard_normal(T)
    return x


def _bias(p, biased):
    if biased:
        p = dict(p, router=p["router"].copy())
        p["router"][0, BIASED] += 6.0
    return p


def _t(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _repro_routing(x, router, k, capacity):
    """``repro``'s ``_moe_local`` steps 1-4 on one group (its lines, run in
    JAX): (logits, experts, blk, valid)."""
    T_ = x.shape[0]
    E = router.shape[1]
    logits = jnp.asarray(x) @ jnp.asarray(router)
    _, topi = jax.lax.top_k(logits, k)
    flat = topi.reshape(-1)
    order = jnp.argsort(flat)
    sizes = jnp.bincount(flat[order], length=E)
    offsets = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                               jnp.cumsum(sizes)[:-1].astype(jnp.int32)])
    pad = jnp.concatenate([order, jnp.full((capacity,), T_ * k, order.dtype)])
    blk = jax.vmap(lambda e: jax.lax.dynamic_slice(
        pad, (offsets[e],), (capacity,)))(jnp.arange(E))
    valid = (jnp.arange(capacity)[None, :] < sizes[:, None]) & \
        (blk < T_ * k)
    return (np.asarray(logits), np.asarray(topi), np.asarray(blk),
            np.asarray(valid))


def _near_ties(logits, k):
    """The tokens whose k-th and (k+1)-th logits lie within 1e-5 of their
    largest |logit| (a mask)."""
    s = -np.sort(-logits.astype(np.float64), axis=-1)
    gap = s[:, k - 1] - s[:, k]
    return gap <= 1e-5 * np.abs(logits).max(axis=-1)


def _close(got, want, frac):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("n_tokens", [1, 4, 32, 64, 127, 4096, 8192])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_moe_capacity_matches_repro(geometry, n_tokens):
    E, k = GEOMETRIES[geometry]
    for factor in (1.0, 1.25, 2.0):
        got = M.moe_capacity(n_tokens, k, E, factor)
        assert got == JM.moe_capacity(n_tokens, k, E, factor)
        assert got % 8 == 0 and got >= 8


@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_moe_apply_matches_repro(geometry, act, n_groups, biased):
    E, k = GEOMETRIES[geometry]
    p = _bias(_params(E, act), biased)
    assert ("w_gate" in p) == (act == "silu")
    x = _inputs(E, biased)
    cap = M.moe_capacity(T // n_groups, k, E, 1.25)
    want = jax.jit(functools.partial(JM.moe_apply, top_k=k, capacity=cap,
                                     act=act, n_groups=n_groups))(
        jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()})
    got = M.moe_apply(torch.from_numpy(x), _t(p), top_k=k, capacity=cap,
                      act=act, n_groups=n_groups)
    _close(got, want, 1e-5)

    # the routing, group by group: chosen experts, slots, dropped slots
    n = T // n_groups
    dropped = 0
    for g in range(n_groups):
        xs = x[g * n:(g + 1) * n]
        logits, topi, blk, valid = _repro_routing(xs, p["router"], k, cap)
        ties = _near_ties(logits, k)
        assert int(ties.sum()) == NEAR_TIES.get((geometry, biased, g), 0)
        r = M.route(torch.from_numpy(xs), torch.from_numpy(p["router"]), k,
                    cap)
        np.testing.assert_array_equal(r.experts.numpy()[~ties], topi[~ties])
        np.testing.assert_array_equal(r.valid.numpy(), valid)
        np.testing.assert_array_equal(np.where(valid, r.blk.numpy(), -1),
                                      np.where(valid, blk, -1))
        kept = np.zeros(n * k, bool)
        kept[blk[valid]] = True
        np.testing.assert_array_equal((r.slot.numpy() >= 0).reshape(-1),
                                      kept)
        dropped += int((~kept).sum())
    # the biased router sends every token of a group to expert BIASED,
    # past its capacity
    if biased:
        assert n > cap and dropped >= n_groups * (n - cap), (dropped, cap)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_moe_gradients_match_jax_grad(geometry, act):
    """d/d(x, every leaf) of sum(out * c) for a seeded c, the biased router
    (assignments dropped): within 1e-4 of each one's largest |g|."""
    E, k = GEOMETRIES[geometry]
    p = _bias(_params(E, act, seed=2), True)
    x = _inputs(E, True, seed=3)
    c = np.random.default_rng(4).standard_normal((T, D)).astype(np.float32)
    cap = M.moe_capacity(T, k, E, 1.25)

    def jloss(x_, p_):
        out = JM.moe_apply(x_, p_, top_k=k, capacity=cap, act=act)
        return jnp.sum(out * jnp.asarray(c))
    assert not _near_ties(_repro_routing(x, p["router"], k, cap)[0],
                          k).any()
    jgx, jgp = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()})
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = {n: v.requires_grad_(True) for n, v in _t(p).items()}
    out = M.moe_apply(tx, tp, top_k=k, capacity=cap, act=act)
    torch.sum(out * torch.from_numpy(c)).backward()
    _close(tx.grad, jgx, 1e-4)
    for n in p:
        _close(tp[n].grad, jgp[n], 1e-4)
        assert np.abs(np.asarray(jgp[n])).max() > 0, n


def test_dropped_assignments_pass_nothing():
    """A token over its expert's capacity gets nothing from that expert:
    with every token choosing expert BIASED first, tokens past the first
    ``capacity`` of them get only their second expert's output."""
    E, k = 4, 2
    p = _bias(_params(E, "silu"), True)
    x = torch.from_numpy(_inputs(E, True))
    cap = 8
    r = M.route(x, torch.from_numpy(p["router"]), k, cap)
    assert bool((r.experts[:, 0] == BIASED).all())
    first = r.slot[:, 0]
    assert bool((first[:cap] >= 0).all()) and bool((first[cap:] < 0).all())
    out = M.moe_apply(x, _t(p), top_k=k, capacity=cap, act="silu")
    alone = dict(_t(p))
    for n in ("w_up", "w_down", "w_gate"):       # expert BIASED silenced
        alone[n] = alone[n].clone()
        alone[n][BIASED] = 0.0
    quiet = M.moe_apply(x, alone, top_k=k, capacity=cap, act="silu")
    assert torch.equal(out[cap:], quiet[cap:])
    assert not torch.equal(out[:cap], quiet[:cap])


def test_moe_apply_is_bitwise_from_call_to_call():
    E, k = GEOMETRIES["kimi"]
    p = _t(_bias(_params(E, "silu"), True))
    x = torch.from_numpy(_inputs(E, True))
    a = M.moe_apply(x, p, top_k=k, capacity=8, act="silu")
    b = M.moe_apply(x, p, top_k=k, capacity=8, act="silu")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="dispatch groups"):
        M.moe_apply(x[:63], p, top_k=k, capacity=8, act="silu", n_groups=2)


def test_top_k_ties_go_to_the_lower_expert():
    """Equal logits: ``jax.lax.top_k`` takes the lower index first, so does
    the port's stable sort."""
    router = np.zeros((D, 6), np.float32)
    x = np.ones((5, D), np.float32)
    r = M.route(torch.from_numpy(x), torch.from_numpy(router), 3, 8)
    _, topi = jax.lax.top_k(jnp.asarray(x) @ jnp.asarray(router), 3)
    np.testing.assert_array_equal(r.experts.numpy(), np.asarray(topi))
    np.testing.assert_array_equal(r.experts.numpy(), [[0, 1, 2]] * 5)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_aux_load_balance_loss_matches_repro(geometry):
    E, k = GEOMETRIES[geometry]
    rng = np.random.default_rng(E)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    topi = np.argsort(-logits, axis=-1)[:, :k].astype(np.int32)
    want = float(JM.aux_load_balance_loss(jnp.asarray(logits),
                                          jnp.asarray(topi), E))
    got = float(M.aux_load_balance_loss(torch.from_numpy(logits),
                                        torch.from_numpy(topi), E))
    assert abs(got - want) <= 1e-6 * abs(want)
