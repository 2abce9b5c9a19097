"""The serving path: prefill, KV-cache decode and ``serve_step`` of the
port against ``repro`` on the CPU, and the serving launcher.

Models: the reduced ``flaas-100m`` (``configs.reduced``: 2 layers,
d=64) and a ``swa`` variant with window 8, with ``repro``'s own initial
parameters carried across by ``params_from_jax``; prompts are seeded
numpy arrays.  Logits hold within 1e-4 of the largest |logit| (the bound
of ``repro``'s ``tests/test_models.py`` decode check), cache entries
within 2e-5 (the projections of order 1), greedy tokens exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.models import (decode_step, forward, forward_with_cache,
                                init_cache, init_model, params_from_jax)
from repro_torch.training import serve_step

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import decode_step as jdecode_step  # noqa: E402
from repro.models import forward_with_cache as jforward_with_cache  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.training import serve_step as jserve_step  # noqa: E402

SMALL = jreduced(jget_arch("flaas-100m"))
CONFIGS = {
    "flaas-smoke": SMALL,
    "swa-smoke": dataclasses.replace(SMALL, name="swa-smoke", window=8,
                                     pattern=(("swa", False),)),
}
RTOL_LOGITS = 1e-4
ATOL_CACHE = 2e-5


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


def _setup(name, seed=0):
    cfg = CONFIGS[name]
    tree = jax.device_get(jinit(jax.random.PRNGKey(seed), cfg,
                                dtype=jnp.float32))
    return cfg, tree, params_from_jax(tree, cfg, device="cpu")


def _prompts(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)
                                                ).astype(np.int32)


def _close_logits(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= RTOL_LOGITS * np.abs(want).max(), err


def _jax_cache_blocks(cache, cfg):
    """``repro``'s cache pytree as one ``{"k", "v"}`` per block in layer
    order (prefix, body group by group, suffix)."""
    out = [dict(c) for c in cache["prefix"]]
    for g in range(cfg.n_groups):
        for pos in range(len(cfg.pattern)):
            out.append({n: np.asarray(a)[g]
                        for n, a in cache["body"][pos].items()})
    return out + [dict(c) for c in cache["suffix"]]


def _close_cache(got, want, cfg):
    want = _jax_cache_blocks(want, cfg)
    assert len(got) == len(want) == cfg.n_layers
    for g, w in zip(got, want):
        for n in ("k", "v"):
            np.testing.assert_allclose(g[n].numpy(), np.asarray(w[n]),
                                       rtol=0, atol=ATOL_CACHE)


# (config, prompt length, cache length): the swa cases wrap the ring
# (S > window) in the prefill, or during the decode
CASES = [("flaas-smoke", 12, 20), ("flaas-smoke", 5, 5),
         ("swa-smoke", 6, 16), ("swa-smoke", 13, 20)]


@pytest.mark.parametrize("name,S,cache_len", CASES)
def test_prefill_and_cache_match_repro(name, S, cache_len):
    cfg, tree, model = _setup(name)
    tok = _prompts(cfg, 2, S)
    want, jcache = jforward_with_cache(tree, jnp.asarray(tok), cfg,
                                       cache_len=cache_len)
    got, cache = forward_with_cache(model, torch.from_numpy(tok), cfg,
                                    cache_len)
    _close_logits(got, want)
    _close_cache(cache, jcache, cfg)
    Lc = min(cfg.window or cache_len, cache_len)
    assert all(c["k"].shape == (2, Lc, cfg.kv_heads, cfg.dh) for c in cache)


@pytest.mark.parametrize("name,S,cache_len", CASES[:1] + CASES[2:])
def test_decode_steps_match_repro(name, S, cache_len):
    """Teacher-forced decode steps (the same tokens on both sides): logits
    at every step and the cache after the last."""
    cfg, tree, model = _setup(name)
    tok = _prompts(cfg, 2, cache_len, seed=1)
    _, jcache = jforward_with_cache(tree, jnp.asarray(tok[:, :S]), cfg,
                                    cache_len=cache_len)
    _, cache = forward_with_cache(model, torch.from_numpy(tok[:, :S]), cfg,
                                  cache_len)
    for pos in range(S, cache_len):
        step = tok[:, pos:pos + 1]
        want, jcache = jdecode_step(tree, jnp.asarray(step), jcache,
                                    jnp.asarray(pos), cfg)
        got, cache = decode_step(model, torch.from_numpy(step), cache, pos,
                                 cfg)
        assert tuple(got.shape) == (2, 1, cfg.vocab)
        _close_logits(got, want)
    _close_cache(cache, jcache, cfg)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_serve_steps_match_repro(name):
    cfg, tree, model = _setup(name)
    S, gen = 10, 8
    tok = _prompts(cfg, 3, S, seed=2)
    jl, jcache = jforward_with_cache(tree, jnp.asarray(tok), cfg,
                                     cache_len=S + gen)
    tl, cache = forward_with_cache(model, torch.from_numpy(tok), cfg,
                                   S + gen)
    jt = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    tt = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    for i in range(gen - 1):
        jt, jlg, jcache = jserve_step(tree, jt, jcache, jnp.asarray(S + i),
                                      cfg)
        tt, tlg, cache = serve_step(model, tt, cache, S + i, cfg)
        _close_logits(tlg, jlg)
        assert tt.dtype == torch.int32
        assert np.array_equal(tt.numpy(), np.asarray(jt)), i


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_matches_forward(name):
    """The port on its own, as repro's tests/test_models.py checks repro:
    prefill S-1 tokens and decode the last gives the full forward's last
    logits; for swa at S = 2 * window + 3, past the ring's wrap."""
    cfg, _, model = _setup(name, seed=1)
    S = 2 * (cfg.window or 8) + 3
    tok = torch.from_numpy(_prompts(cfg, 2, S, seed=3))
    full = forward(model, tok, cfg).detach()
    _, cache = forward_with_cache(model, tok[:, :S - 1], cfg, S)
    lg, _ = decode_step(model, tok[:, S - 1:], cache, S - 1, cfg)
    _close_logits(lg[:, 0], full[:, S - 1])
    # and step by step from a one-token prefill
    _, cache = forward_with_cache(model, tok[:, :1], cfg, S)
    for pos in range(1, S):
        lg, cache = decode_step(model, tok[:, pos:pos + 1], cache, pos, cfg)
        _close_logits(lg[:, 0], full[:, pos])


def test_init_cache_layout():
    cfg, _, model = _setup("swa-smoke")
    cache = init_cache(model, cfg, 3, 20)
    assert len(cache) == cfg.n_layers
    for c in cache:
        for n in ("k", "v"):
            assert c[n].shape == (3, 8, cfg.kv_heads, cfg.dh)
            assert c[n].dtype == torch.float32 and not c[n].any()
    cfg, _, model = _setup("flaas-smoke")
    assert init_cache(model, cfg, 1, 20)[0]["k"].shape == \
        (1, 20, cfg.kv_heads, cfg.dh)


def test_sampling_is_reproducible_from_the_generator_seed():
    cfg, _, model = _setup("flaas-smoke")
    tok = torch.from_numpy(_prompts(cfg, 4, 6, seed=4))

    def sample(seed, temperature=1.0):
        _, cache = forward_with_cache(model, tok, cfg, 12)
        gen = torch.Generator().manual_seed(seed)
        t, out = tok[:, -1:], []
        for pos in range(6, 12):
            t, _, cache = serve_step(model, t, cache, pos, cfg,
                                     temperature=temperature, generator=gen)
            out.append(t)
        return torch.cat(out, dim=1)

    a, b, c = sample(5), sample(5), sample(6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab
    with pytest.raises(ValueError):
        _, cache = forward_with_cache(model, tok, cfg, 12)
        serve_step(model, tok[:, -1:], cache, 6, cfg, temperature=1.0)


def _count_twins(monkeypatch):
    """Count the calls of the two attention twins (they still run)."""
    calls = {"flash_attention": 0, "decode_attention": 0}

    def counted(name):
        twin = getattr(ref, name + "_ref")

        def call(*a, **kw):
            calls[name] += 1
            return twin(*a, **kw)
        monkeypatch.setattr(ref, name + "_ref", call)
    counted("flash_attention")
    counted("decode_attention")
    return calls


def test_serve_launcher_on_the_cpu(capsys, monkeypatch):
    """``python -m repro_torch.launch.serve --device cpu --smoke``: one
    flash call per layer in the prefill, one decode call per layer in each
    of the gen - 1 steps, and no kernel launch (the twins ran)."""
    gen = 5
    calls = _count_twins(monkeypatch)
    rec = serve.main(["--device", "cpu", "--smoke", "--gen", str(gen)])
    n = rec["cfg"].n_layers
    assert calls == {"flash_attention": n, "decode_attention": n * (gen - 1)}
    assert rec["launches"] == {"flash_attention": 0, "decode_attention": 0,
                               "rglru_scan": 0}
    assert rec["tokens"].shape == (4, gen)
    assert len(rec["step_ms"]) == gen - 1
    out = capsys.readouterr().out
    assert "prefill 4x32" in out and "tok/s" in out


def test_serve_run_teacher_forced_and_sampled():
    base = serve.run(smoke=True, device="cpu", gen=6, keep_logits=True,
                     log=None)
    V = base["cfg"].vocab
    assert base["logits"]["prefill"].shape == (4, 32, V)
    assert base["logits"]["decode"].shape == (4, 5, V)
    forced = serve.run(smoke=True, device="cpu", gen=6, feed=base["tokens"],
                       keep_logits=True, log=None)
    assert torch.equal(forced["tokens"], base["tokens"])
    assert torch.equal(forced["logits"]["decode"], base["logits"]["decode"])
    s1, s2 = (serve.run(smoke=True, device="cpu", gen=6, temperature=1.0,
                        seed=3, log=None)["tokens"] for _ in range(2))
    assert torch.equal(s1, s2)


def test_serve_draws_the_same_model_and_prompts_on_every_device():
    """Parameters and prompts come from CPU generators, so a card run
    serves what the CPU run serves."""
    cfg = reduced(get_arch("flaas-100m"))
    host = init_model(cfg, 7, device="cpu")
    assert torch.equal(serve.make_model(cfg, 7, torch.device("cpu")).flat,
                       host.flat)
    meta = serve.make_model(cfg, 7, torch.device("meta"))
    assert meta.flat.device.type == "meta"


@pytest.mark.parametrize("kind", ["attn", "swa"])
def test_moe_blocks_build_and_serve(monkeypatch, kind):
    """The reduced flaas-100m with MoE blocks (4 experts, top 2) builds,
    caches and serves on the CPU through the same attention twins, one
    flash call per layer and one decode call per layer a step."""
    from repro_torch.configs import MoESpec
    cfg = dataclasses.replace(
        CONFIGS["flaas-smoke"], pattern=((kind, True),), window=8,
        moe=MoESpec(n_experts=4, top_k=2))
    model = init_model(cfg, 0, device="cpu")
    assert all(blk.use_moe and "w_up" in blk.moe for blk in model.blocks)
    cache = init_cache(model, cfg, 2, 8)
    assert set(cache[0]) == {"k", "v"}
    logits, cache = forward_with_cache(model, torch.zeros(2, 4), cfg, 8)
    logits, _ = decode_step(model, torch.zeros(2, 1), cache, 4, cfg)
    assert logits.shape == (2, 1, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    calls = _count_twins(monkeypatch)
    rec = serve.run(model=model, batch=2, prompt_len=4, gen=3, log=None)
    assert rec["tokens"].shape == (2, 3)
    n = cfg.n_layers
    assert calls == {"flash_attention": n, "decode_attention": 2 * n}


@pytest.mark.parametrize("kind", ["xattn", "encdec"])
def test_cross_attention_kinds_build_and_serve(kind):
    """The reduced flaas-100m with its blocks made ``xattn`` or ``encdec``
    (and, for ``encdec``, an encoder) builds, caches and serves on the
    CPU, the cross entries of the memory's length."""
    from repro_torch.configs import EncoderSpec
    cfg = dataclasses.replace(
        CONFIGS["flaas-smoke"], pattern=(("attn", False), (kind, False)),
        cross_memory_len=7,
        encoder=EncoderSpec(n_layers=1) if kind == "encdec" else None)
    model = init_model(cfg, 0, device="cpu")
    mem = torch.randn((2, 7, cfg.d_model),
                      generator=torch.Generator().manual_seed(0))
    arg = {"enc_frames" if kind == "encdec" else "memory": mem}
    cache = init_cache(model, cfg, 2, 8, **arg)
    assert cache[1]["xk"].shape == (2, 7, cfg.kv_heads, cfg.dh)
    logits, cache = forward_with_cache(model, torch.zeros(2, 4), cfg, 8,
                                       **arg)
    assert logits.shape == (2, 4, cfg.vocab)
    logits, _ = decode_step(model, torch.zeros(2, 1), cache, 4, cfg)
    assert bool(torch.isfinite(logits).all())
    rec = serve.run(model=model, batch=2, prompt_len=4, gen=3, log=None,
                    **arg)
    assert rec["tokens"].shape == (2, 3)


def test_serving_counts_match_the_depth(monkeypatch):
    cfg, _, model = _setup("swa-smoke")
    calls = _count_twins(monkeypatch)
    fa.reset_launches()
    da.reset_launches()
    tok = torch.from_numpy(_prompts(cfg, 1, 4))
    _, cache = forward_with_cache(model, tok, cfg, 9)
    for pos in range(4, 9):
        _, cache = decode_step(model, tok[:, :1], cache, pos, cfg)
    assert calls == {"flash_attention": cfg.n_layers,
                     "decode_attention": 5 * cfg.n_layers}
    assert fa.LAUNCHES["flash_attention"] == da.LAUNCHES[
        "decode_attention"] == 0
