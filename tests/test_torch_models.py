"""Layers and the transformer: the port against ``repro`` on the CPU.

Parameters are ``repro``'s own initial values, carried across by
``params_from_jax``; inputs are seeded numpy arrays.  Everything runs in
float32 on both sides.  Tolerance: 2e-5 absolute on outputs of order 1-10
(XLA and PyTorch round ``exp``, ``rsqrt``, ``pow`` and matmul sums in their
own order; measured gaps are ~3e-6), and 1e-5 relative on losses.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.models import (Transformer, forward, init_model, lm_loss,
                                params_from_jax)
from repro_torch.models import layers as L

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm_loss as jlm_loss  # noqa: E402

ATOL = 2e-5

SMALL = reduced(jget_arch("flaas-100m"))
CONFIGS = {
    "flaas-smoke": SMALL,
    "gqa-window": dataclasses.replace(
        SMALL, name="gqa-window", n_layers=3, kv_heads=2, window=4,
        pattern=(("swa", False), ("attn", False))),
    "layernorm-gelu-bias-tied": dataclasses.replace(
        SMALL, name="ln-gelu", norm="layernorm", act="gelu", qkv_bias=True,
        tie_embeddings=True, n_heads=4, kv_heads=1),
}


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, _np(want), rtol=0, atol=atol)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_norms(rng):
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3
    p = {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
         "bias": rng.standard_normal(16).astype(np.float32)}
    tp = {k: _t(v) for k, v in p.items()}
    _close(L.rmsnorm(_t(x), tp), JL.rmsnorm(jnp.asarray(x), p))
    _close(L.layernorm(_t(x), tp), JL.layernorm(jnp.asarray(x), p))


def test_rope(rng):
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7) + 5
    _close(L.apply_rope(_t(x), _t(pos), 10000.0),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    cos, sin = L.rope_angles(_t(pos), 16, 500.0)
    jcos, jsin = JL.rope_angles(jnp.asarray(pos), 16, 500.0)
    _close(cos, jcos)
    _close(sin, jsin)


@pytest.mark.parametrize("bias", [False, True])
def test_qkv_project(rng, bias):
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    p = {"wq": rng.standard_normal((16, 32)), "wk": rng.standard_normal(
        (16, 16)), "wv": rng.standard_normal((16, 16))}
    if bias:
        p.update(bq=rng.standard_normal(32), bk=rng.standard_normal(16),
                 bv=rng.standard_normal(16))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    got = L.qkv_project(_t(x), {k: _t(v) for k, v in p.items()}, 4, 2, 8)
    want = JL.qkv_project(jnp.asarray(x), p, 4, 2, 8)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, atol=1e-4)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 4),
                                           (False, None), (False, 3)])
@pytest.mark.parametrize("Sq,Skv,q_offset", [(13, 13, 0), (3, 13, 10)])
@pytest.mark.parametrize("chunk", [5, 1024])
def test_chunked_attention_gqa(rng, causal, window, Sq, Skv, q_offset,
                               chunk):
    q = rng.standard_normal((2, Sq, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, Skv, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, Skv, 2, 8)).astype(np.float32)
    got = L.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window, q_offset=q_offset, chunk=chunk)
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                q_offset=q_offset, chunk=chunk)
    assert tuple(got.shape) == (2, Sq, 4, 8)
    _close(got, want)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_embed_head(rng, act):
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    p = {"w_up": rng.standard_normal((16, 24)) * 0.3,
         "w_down": rng.standard_normal((24, 16)) * 0.3,
         "w_gate": rng.standard_normal((16, 24)) * 0.3}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    _close(L.mlp(_t(x), {k: _t(v) for k, v in p.items()}, act),
           JL.mlp(jnp.asarray(x), p, act))
    table = rng.standard_normal((11, 16)).astype(np.float32)
    tok = rng.integers(0, 11, (2, 5)).astype(np.int32)
    _close(L.embed(_t(tok), {"table": _t(table)}),
           JL.embed(jnp.asarray(tok), {"table": table}), atol=0)
    w = rng.standard_normal((16, 11)).astype(np.float32)
    _close(L.lm_head(_t(x), {"w": _t(w)}), JL.lm_head(jnp.asarray(x),
                                                      {"w": w}), atol=1e-4)


def _jax_params(cfg, seed=0):
    return jax.device_get(jinit(jax.random.PRNGKey(seed), cfg,
                                dtype=jnp.float32))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_and_loss_match_repro(rng, name):
    cfg = CONFIGS[name]
    tree = _jax_params(cfg)
    model = params_from_jax(tree, cfg, device="cpu")
    tok = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    mask = (rng.random((2, 12)) < 0.8).astype(np.float32)
    want = jforward(tree, jnp.asarray(tok), cfg)
    got = forward(model, _t(tok), cfg).detach()
    _close(got, want)
    for m in (None, mask):
        jl = float(jlm_loss(want, jnp.asarray(lab),
                            None if m is None else jnp.asarray(m)))
        tl = float(lm_loss(got, _t(lab), None if m is None else _t(m)))
        assert abs(tl - jl) <= 1e-5 * abs(jl)


def test_params_from_jax_lays_out_every_leaf_once():
    cfg = CONFIGS["gqa-window"]
    tree = _jax_params(cfg, seed=3)
    model = params_from_jax(tree, cfg, device="cpu")
    leaves = jax.tree.leaves(tree)
    assert model.flat.numel() == sum(np.asarray(x).size for x in leaves)
    assert np.isclose(float(model.flat.double().sum()),
                      sum(float(np.asarray(x, np.float64).sum())
                          for x in leaves), rtol=1e-9)
    # layer order: the body's group g, pattern position p is block 2g+p
    wq = np.asarray(tree["body"][1]["attn"]["wq"])[0]
    assert np.array_equal(model.blocks[1].attn["wq"].detach().numpy(), wq)
    assert [b.kind for b in model.blocks] == ["swa", "attn", "swa"]
    # every parameter is a view of the flat buffer
    with torch.no_grad():
        model.flat.zero_()
    assert all(float(p.detach().abs().sum()) == 0 for p in model.parameters())


def test_init_model_draws_from_a_seeded_generator():
    cfg = reduced(get_arch("flaas-100m"))
    a, b = init_model(cfg, 5, device="cpu"), init_model(cfg, 5, device="cpu")
    c = init_model(cfg, 6, device="cpu")
    assert torch.equal(a.flat, b.flat) and not torch.equal(a.flat, c.flat)
    full = dict(init_model(dataclasses.replace(cfg, d_model=256,
                                               head_dim=64), 0,
                           device="cpu").named_parameters())
    assert abs(float(full["blocks.0.attn.wq"].std()) - 1 / 16) < 2e-3
    assert abs(float(full["embed.table"].std()) - 0.02) < 1e-3
    assert torch.equal(full["final_norm.scale"], torch.ones(256))


def test_full_flaas_100m_parameter_count():
    cfg = get_arch("flaas-100m")
    model = Transformer(cfg, device="meta")
    assert model.flat.numel() == 124_668_672
    assert len(model.blocks) == 12


def test_moe_configs_build():
    """``get_arch`` knows the MoE configs; a MoE block builds with the
    experts' leaves, forwards and trains (its gradient reaches them), and
    an unknown block kind is refused."""
    assert get_arch("mixtral-8x22b").moe.n_experts == 8
    from repro_torch.configs import MoESpec
    cfg = dataclasses.replace(SMALL, pattern=(("attn", True),),
                              moe=MoESpec(n_experts=4, top_k=2))
    model = init_model(cfg, 0, device="cpu")
    tok = torch.zeros((2, 5), dtype=torch.int64)
    loss = lm_loss(forward(model, tok, cfg), tok)
    loss.backward()
    assert model.blocks[0].moe["w_up"].grad.abs().max() > 0
    assert not hasattr(model.blocks[0], "mlp")
    with pytest.raises(ValueError, match="kind"):
        Transformer(dataclasses.replace(SMALL, pattern=(("moe", False),)),
                    device="meta")
