"""The MoE family -- ``mixtral-8x22b`` (``swa`` blocks, every MLP a mixture
of 8 experts, top 2) and ``kimi-k2-1t-a32b`` (a dense ``attn`` prefix
layer at ``dense_ff``, then ``attn`` blocks with 384 experts, top 8, and
a shared expert) -- on the port's serving path against ``repro`` on the
CPU; their configs equal to ``repro``'s; their full parameter counts and
leaves.  Training: ``test_torch_moe_train``.

Models: ``configs.reduced`` (mixtral: 2 layers, window 8; kimi: the
prefix and 2 MoE layers, the shared expert kept; both d=64, 4 heads, dh
16, 4 experts top 2, capacity factor 1.25), ``repro``'s initial float32
parameters carried across by ``params_from_jax`` with the norm scales
seeded nonzero on both sides (``test_torch_xattn.perturbed_tree``); the
experts' banks start at ``repro``'s ``N(0, 1/E)``.  B = 2, prompt 9, gen
6 (mixtral's 8-slot ring wraps); each path routes the tokens of its own
call, as ``repro`` does: the prefill B*S tokens, a decode step B
(capacity 8).  Tolerances: logits within 1e-4 of the largest |logit|,
cache entries within 2e-5, greedy tokens exactly, the loss within 1e-5
relative.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.launch import serve
from repro_torch.models import (Transformer, decode_step, forward,
                                forward_with_cache, lm_loss, params_from_jax)
from repro_torch.training import serve_step

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import decode_step as _jdecode_step  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import forward_with_cache as jforward_with_cache  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models import lm_loss as jlm_loss  # noqa: E402
from repro.training import serve_step as _jserve_step  # noqa: E402

from test_torch_xattn import (GEN, PROMPT, close_logits,  # noqa: E402
                              perturbed_tree, prompts, twin_counter)

ARCHS_MOE = ("mixtral-8x22b", "kimi-k2-1t-a32b")
# repro's steps compiled once per config (the position is traced)
jdecode_step = jax.jit(_jdecode_step, static_argnums=4)
jserve_step = jax.jit(_jserve_step, static_argnums=4)
ATOL_CACHE = 2e-5
SEQ = 12


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


def _tb(tok, lab):
    return {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}


def _jb(tok, lab):
    return {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}


def _flat(tree, cfg):
    return params_from_jax(jax.device_get(tree), cfg, device="cpu").flat


def _close(got, want, frac):
    got, want = got.detach().double(), want.detach().double()
    err = float((got - want).abs().max())
    assert err <= frac * float(want.abs().max()), err


def _batch(cfg, seed, Bt=4):
    t = np.random.default_rng(seed).integers(0, cfg.vocab, (Bt, SEQ + 1)
                                              ).astype(np.int32)
    return t[:, :-1], t[:, 1:]


@pytest.fixture(scope="module", params=ARCHS_MOE)
def setup(request):
    cfg = jreduced(jget_arch(request.param))
    tree = perturbed_tree(cfg, seed=len(request.param))
    return cfg, tree, params_from_jax(tree, cfg, device="cpu")


def _close_cache(got, want, cfg):
    """The port's per-layer cache against ``repro``'s prefix and stacked
    body."""
    blocks = list(want["prefix"])
    P = len(cfg.pattern)
    blocks += [{n: np.asarray(a)[g] for n, a in want["body"][pos].items()}
               for g in range(cfg.n_groups) for pos in range(P)]
    assert len(got) == len(blocks) == cfg.n_layers
    for g, w in zip(got, blocks):
        assert set(g) == set(w) == {"k", "v"}
        for n in ("k", "v"):
            np.testing.assert_allclose(g[n].numpy(), np.asarray(w[n]),
                                       rtol=0, atol=ATOL_CACHE)


@pytest.mark.parametrize("name", ARCHS_MOE)
def test_configs_equal_repros(name):
    got, want = get_arch(name), jget_arch(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(reduced(got)) == \
        dataclasses.asdict(jreduced(want))
    assert name in ARCHS and set(ARCHS) == set(
        __import__("repro.configs", fromlist=["ARCHS"]).ARCHS)


@pytest.mark.parametrize("name", ARCHS_MOE)
def test_full_parameter_counts(name):
    """The port on the meta device against ``jax.eval_shape`` of
    ``repro``'s ``init_model``: nothing is allocated on either side."""
    cfg = get_arch(name)
    shapes = jax.eval_shape(
        lambda k: jinit(k, jget_arch(name), dtype=jnp.float32),
        jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    model = Transformer(cfg, device="meta")
    assert model.flat.numel() == want
    assert len(model.blocks) == cfg.n_layers
    moe = sum(p.numel() for b in model.blocks if b.use_moe
              for n, p in b.named_parameters() if n.startswith("moe."))
    assert moe == sum(cfg.moe.n_experts * 3 * cfg.d_model * cfg.d_ff +
                      cfg.d_model * cfg.moe.n_experts
                      for _, m in cfg.layer_specs() if m)


def test_block_leaves():
    """kimi's prefix block keeps a dense ``mlp`` at ``dense_ff``; a MoE
    block holds ``moe`` (router, banks) and ``shared`` at ``d_ff *
    n_shared``, no ``mlp``; mixtral's blocks ``moe`` alone."""
    cfg = get_arch("kimi-k2-1t-a32b")
    model = Transformer(cfg, device="meta")
    D, E = cfg.d_model, cfg.moe.n_experts
    dense = dict(model.blocks[0].named_parameters())
    assert dense["mlp.w_up"].shape == (D, cfg.dense_ff)
    assert not any(n.startswith(("moe.", "shared.")) for n in dense)
    blk = dict(model.blocks[1].named_parameters())
    assert {n for n in blk if n.startswith("moe.")} == {
        "moe.router", "moe.w_up", "moe.w_down", "moe.w_gate"}
    assert blk["moe.router"].shape == (D, E)
    assert blk["moe.w_up"].shape == (E, D, cfg.d_ff)
    assert blk["moe.w_down"].shape == (E, cfg.d_ff, D)
    assert blk["shared.w_up"].shape == (D, cfg.d_ff * cfg.moe.n_shared)
    assert not any(n.startswith("mlp.") for n in blk)
    mix = Transformer(get_arch("mixtral-8x22b"), device="meta")
    names = {n.split(".")[0] for n, _ in mix.blocks[0].named_parameters()}
    assert names == {"norm1", "attn", "norm2", "moe"}


def test_params_from_jax_holds_every_leaf(setup):
    """Every leaf of ``repro``'s tree lands on the port's parameter of the
    same name; a tree missing a leaf is refused."""
    cfg, tree, model = setup
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert sum(np.size(a) for a in jax.tree_util.tree_leaves(tree)) == \
        model.flat.numel()
    P = len(cfg.pattern)
    base = len(cfg.prefix)
    for g in range(cfg.n_groups):
        for pos in range(P):
            for leaf, a in tree["body"][pos]["moe"].items():
                assert np.array_equal(
                    got[f"blocks.{base + g * P + pos}.moe.{leaf}"],
                    np.asarray(a)[g])
    if cfg.prefix:
        for leaf, a in tree["prefix"][0]["mlp"].items():
            assert np.array_equal(got[f"blocks.0.mlp.{leaf}"], a)
    short = jax.tree_util.tree_map(lambda x: x, tree)
    del short["body"][0]["moe"]["w_gate"]
    with pytest.raises(KeyError):
        params_from_jax(short, cfg, device="cpu")


def test_forward_and_loss_match_repro(setup):
    cfg, tree, model = setup
    tok, lab = prompts(cfg, PROMPT, seed=3), prompts(cfg, PROMPT, seed=4)
    got = forward(model, torch.from_numpy(tok), cfg)
    want = jforward(tree, jnp.asarray(tok), cfg)
    close_logits(got.detach(), want)
    loss = float(lm_loss(got, torch.from_numpy(lab)).detach())
    jloss = float(jlm_loss(want, jnp.asarray(lab)))
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)


def test_prefill_and_cache_match_repro(setup):
    cfg, tree, model = setup
    tok = prompts(cfg, PROMPT)
    want, jcache = jforward_with_cache(tree, jnp.asarray(tok), cfg,
                                       cache_len=PROMPT + GEN)
    got, cache = forward_with_cache(model, torch.from_numpy(tok), cfg,
                                    PROMPT + GEN)
    close_logits(got, want)
    _close_cache(cache, jcache, cfg)


def test_decode_steps_match_repro(setup):
    """Teacher-forced decode steps, each routing B tokens (capacity 8):
    logits and every cache entry after each step."""
    cfg, tree, model = setup
    tok = prompts(cfg, PROMPT + GEN, seed=1)
    _, jcache = jforward_with_cache(tree, jnp.asarray(tok[:, :PROMPT]), cfg,
                                    cache_len=PROMPT + GEN)
    _, cache = forward_with_cache(model, torch.from_numpy(tok[:, :PROMPT]),
                                  cfg, PROMPT + GEN)
    for pos in range(PROMPT, PROMPT + GEN):
        step = tok[:, pos:pos + 1]
        want, jcache = jdecode_step(tree, jnp.asarray(step), jcache,
                                    jnp.asarray(pos), cfg)
        got, cache = decode_step(model, torch.from_numpy(step), cache, pos,
                                 cfg)
        close_logits(got, want)
        _close_cache(cache, jcache, cfg)


def test_greedy_serve_steps_match_repro(setup):
    cfg, tree, model = setup
    tok = prompts(cfg, PROMPT, seed=2)
    jl, jcache = jforward_with_cache(tree, jnp.asarray(tok), cfg,
                                     cache_len=PROMPT + GEN)
    tl, cache = forward_with_cache(model, torch.from_numpy(tok), cfg,
                                   PROMPT + GEN)
    jt = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    tt = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    for i in range(GEN - 1):
        jt, jlg, jcache = jserve_step(tree, jt, jcache,
                                      jnp.asarray(PROMPT + i), cfg)
        tt, tlg, cache = serve_step(model, tt, cache, PROMPT + i, cfg)
        close_logits(tlg, jlg)
        assert np.array_equal(tt.numpy(), np.asarray(jt)), i


@pytest.mark.parametrize("name", ARCHS_MOE)
def test_serve_launcher_on_the_cpu(monkeypatch, name):
    """``python -m repro_torch.launch.serve --arch <moe> --device cpu
    --smoke``: one flash call per layer in the prefill, one decode call
    per layer per step after the first, each the twin."""
    calls = twin_counter(monkeypatch)
    gen = 4
    rec = serve.main(["--arch", name, "--device", "cpu", "--smoke",
                      "--gen", str(gen)])
    n = rec["cfg"].n_layers
    assert calls == {"flash_attention": n, "decode_attention": n * (gen - 1)}
    assert rec["tokens"].shape == (4, gen)


def test_a_model_too_large_fails_where_it_is_allocated():
    """The parameters are laid out on the meta device and allocated as one
    flat buffer: a model that cannot fit fails there, its size and
    configuration in the message, before anything is drawn."""
    cfg = dataclasses.replace(reduced(get_arch("mixtral-8x22b")),
                              vocab=2 ** 44)
    n = Transformer(cfg, device="meta").flat.numel()
    with pytest.raises(MemoryError, match=rf"mixtral-8x22b-smoke .*\[{n}\]"):
        Transformer(cfg, device="cpu")
