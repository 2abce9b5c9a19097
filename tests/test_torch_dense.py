"""The dense GQA family -- ``qwen2.5-3b``, ``qwen2.5-32b``,
``starcoder2-3b``, ``starcoder2-15b`` -- on the port's serving and
training paths against ``repro`` on the CPU; the five configs of this
family and of xLSTM equal to ``repro``'s; the full configs' parameter
counts.

Models: each config cut to two layers at d=64, dh 16, vocab 256
(``configs.reduced``) keeping its own head grouping -- 8 query heads over
1 kv head (qwen2.5-3b), 10 over 2 (qwen2.5-32b), 12 over 1 (both
starcoder2) -- and its norm, activation, QKV biases and RoPE theta
(rmsnorm / swiglu, theta 1e6; layernorm / gelu, theta 999,999).
``repro``'s initial float32 parameters are carried across by
``params_from_jax``, with every norm scale and bias and every QKV bias
given seeded nonzero values on both sides (``repro`` starts them at one
and zero).  B = 2, prompt 9, gen 6.  Tolerances (the serving tests'):
logits within 1e-4 of the largest |logit|, cache entries within 2e-5,
greedy tokens exactly, the loss within 1e-5 relative.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.models import (Transformer, decode_step, forward,
                                forward_with_cache, lm_loss, params_from_jax)
from repro_torch.training import serve_step

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import decode_step as jdecode_step  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import forward_with_cache as jforward_with_cache  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models import lm_loss as jlm_loss  # noqa: E402
from repro.training import serve_step as jserve_step  # noqa: E402

# name -> (query heads, kv heads) of the reduced model: the config's G
HEADS = {"qwen2.5-3b": (8, 1), "qwen2.5-32b": (10, 2),
         "starcoder2-3b": (12, 1), "starcoder2-15b": (12, 1)}
# full parameter counts (repro's init_model under jax.eval_shape)
PARAMS = {"qwen2.5-3b": 3_397_103_616, "starcoder2-3b": 3_180_813_312,
          "starcoder2-15b": 15_956_414_464, "qwen2.5-32b": 32_763_876_352,
          "xlstm-125m": 114_510_408}
RTOL_LOGITS = 1e-4
ATOL_CACHE = 2e-5
B, PROMPT, GEN = 2, 9, 6


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


def _cfg(name):
    H, KH = HEADS[name]
    return dataclasses.replace(jreduced(jget_arch(name)), n_heads=H,
                               kv_heads=KH)


def _perturbed_tree(cfg, seed):
    """``repro``'s initial float32 parameters with the norm scales and
    biases and the QKV biases seeded nonzero."""
    tree = jax.device_get(jinit(jax.random.PRNGKey(seed), cfg,
                                dtype=jnp.float32))
    rng = np.random.default_rng(seed + 100)

    def bump(path, x):
        name = str(getattr(path[-1], "key", ""))
        x = np.asarray(x, np.float32)
        if name in ("scale", "bias", "bq", "bk", "bv"):
            return (x + 0.3 * rng.standard_normal(x.shape)).astype(
                np.float32)
        return x
    return jax.tree_util.tree_map_with_path(bump, tree)


@pytest.fixture(scope="module", params=sorted(HEADS))
def setup(request):
    cfg = _cfg(request.param)
    tree = _perturbed_tree(cfg, seed=len(request.param))
    return cfg, tree, params_from_jax(tree, cfg, device="cpu")


def _prompts(cfg, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)
                                                ).astype(np.int32)


def _close_logits(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= RTOL_LOGITS * np.abs(want).max(), err


def _close_cache(got, want, cfg):
    blocks = [{n: np.asarray(a)[g] for n, a in want["body"][0].items()}
              for g in range(cfg.n_groups)]
    assert len(got) == len(blocks) == cfg.n_layers
    for g, w in zip(got, blocks):
        assert set(g) == set(w) == {"k", "v"}
        for n in ("k", "v"):
            np.testing.assert_allclose(g[n].numpy(), w[n], rtol=0,
                                       atol=ATOL_CACHE)


@pytest.mark.parametrize("name", sorted(HEADS) + ["xlstm-125m"])
def test_configs_equal_repros(name):
    got, want = get_arch(name), jget_arch(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(reduced(got)) == \
        dataclasses.asdict(jreduced(want))


@pytest.mark.parametrize("name", ["mixtral-8x22b", "kimi-k2-1t-a32b"])
def test_the_other_configs_equal_repros(name):
    """The last two of repro's configs, and repro's registry whole: the
    port knows every architecture repro knows, each equal to repro's."""
    assert dataclasses.asdict(get_arch(name)) == \
        dataclasses.asdict(jget_arch(name))
    from repro.configs import ARCHS as JARCHS
    assert sorted(ARCHS) == sorted(JARCHS)
    for n in JARCHS:
        assert dataclasses.asdict(get_arch(n)) == \
            dataclasses.asdict(jget_arch(n))


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_full_parameter_counts(name):
    """Counted on the meta device: nothing is allocated."""
    cfg = get_arch(name)
    model = Transformer(cfg, device="meta")
    assert model.flat.device.type == "meta"
    assert model.flat.numel() == PARAMS[name]
    assert len(model.blocks) == cfg.n_layers


def test_reduced_configs_keep_the_head_grouping(setup):
    cfg, tree, model = setup
    full = get_arch(cfg.name.removesuffix("-smoke"))
    assert cfg.n_heads // cfg.kv_heads == full.n_heads // full.kv_heads
    assert (cfg.d_model, cfg.dh, cfg.n_layers, cfg.qkv_bias, cfg.norm,
            cfg.act, cfg.rope_theta) == (64, 16, 2, True, full.norm,
                                         full.act, full.rope_theta)
    bq = model.blocks[1].attn["bq"].detach().numpy()
    assert np.array_equal(bq, np.asarray(tree["body"][0]["attn"]["bq"])[1])
    assert np.abs(bq).min() > 0


def test_prefill_and_cache_match_repro(setup):
    cfg, tree, model = setup
    tok = _prompts(cfg, PROMPT)
    want, jcache = jforward_with_cache(tree, jnp.asarray(tok), cfg,
                                       cache_len=PROMPT + GEN)
    got, cache = forward_with_cache(model, torch.from_numpy(tok), cfg,
                                    PROMPT + GEN)
    _close_logits(got, want)
    _close_cache(cache, jcache, cfg)
    assert cache[0]["k"].shape == (B, PROMPT + GEN, cfg.kv_heads, cfg.dh)


def test_decode_steps_match_repro(setup):
    """Teacher-forced decode steps: logits and every cache entry after
    each step."""
    cfg, tree, model = setup
    tok = _prompts(cfg, PROMPT + GEN, seed=1)
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
        assert tuple(got.shape) == (B, 1, cfg.vocab)
        _close_logits(got, want)
        _close_cache(cache, jcache, cfg)


def test_greedy_serve_steps_match_repro(setup):
    cfg, tree, model = setup
    tok = _prompts(cfg, PROMPT, seed=2)
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
        _close_logits(tlg, jlg)
        assert np.array_equal(tt.numpy(), np.asarray(jt)), i


def test_forward_and_loss_match_repro(setup):
    """The training forward and ``lm_loss``; the gradient reaches the QKV
    biases."""
    cfg, tree, model = setup
    tok = _prompts(cfg, PROMPT, seed=3)
    labels = _prompts(cfg, PROMPT, seed=4)
    got = forward(model, torch.from_numpy(tok), cfg)
    want = jforward(tree, jnp.asarray(tok), cfg)
    _close_logits(got.detach(), want)
    loss = lm_loss(got, torch.from_numpy(labels))
    jloss = float(jlm_loss(want, jnp.asarray(labels)))
    assert abs(float(loss.detach()) - jloss) <= 1e-5 * abs(jloss)
    loss.backward()
    for leaf in ("bq", "bk", "bv"):
        g = model.blocks[0].attn[leaf].grad
        assert g is not None and bool(torch.isfinite(g).all()) and g.any()
    model.zero_grad(set_to_none=True)


def test_serve_launcher_on_the_cpu(monkeypatch):
    """``python -m repro_torch.launch.serve --arch starcoder2-15b --device
    cpu --smoke``: one flash call per layer in the prefill and one decode
    call per layer per step after the first, each the twin."""
    calls = {"flash_attention": 0, "decode_attention": 0}
    for name in calls:
        twin = getattr(ref, name + "_ref")

        def call(*a, _twin=twin, _name=name, **kw):
            calls[_name] += 1
            return _twin(*a, **kw)
        monkeypatch.setattr(ref, name + "_ref", call)
    gen = 4
    rec = serve.main(["--arch", "starcoder2-15b", "--device", "cpu",
                      "--smoke", "--gen", str(gen)])
    n = rec["cfg"].n_layers
    assert calls == {"flash_attention": n, "decode_attention": n * (gen - 1)}
    assert rec["launches"] == {"flash_attention": 0, "decode_attention": 0,
                               "rglru_scan": 0}
    assert rec["tokens"].shape == (4, gen)
