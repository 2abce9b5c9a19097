"""Serving the hybrid ``recurrentgemma-2b`` (``rec`` + ``local`` blocks):
prefill, decode and ``serve_step`` of the port against ``repro`` on the
CPU, and the serving launcher.

Model: ``configs.reduced(recurrentgemma-2b)`` -- 6 layers, (rec, rec,
local) x 2, d=64, 4 query heads over 1 kv head of dh 16, window 8, vocab
256 -- with ``repro``'s own initial parameters carried across by
``params_from_jax``; prompts are seeded numpy arrays.  B = 2, prompt 8,
gen 8 with window 8, so the ``local`` rings wrap during the decode.
Tolerances: logits within 1e-4 of the largest |logit| (the flaas-100m serving
bound); each cache entry (k, v, conv, h) within 1e-5 of its own largest
|value| (the ``rec`` block's bound, ``tests/test_torch_recurrent.py``);
greedy tokens exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import ref
from repro_torch.kernels import rg_lru
from repro_torch.launch import serve
from repro_torch.models import (Transformer, decode_step, forward,
                                forward_with_cache, init_cache,
                                params_from_jax)
from repro_torch.training import serve_step

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import decode_step as jdecode_step  # noqa: E402
from repro.models import forward_with_cache as jforward_with_cache  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.training import serve_step as jserve_step  # noqa: E402

CFG = jreduced(jget_arch("recurrentgemma-2b"))
RTOL_LOGITS = 1e-4               # of the largest |logit|
RTOL_STATE = 1e-5                # of each cache entry's largest |value|
B, PROMPT, GEN = 2, 8, 8


@pytest.fixture(scope="module")
def setup():
    tree = jax.device_get(jinit(jax.random.PRNGKey(0), CFG,
                                dtype=jnp.float32))
    return tree, params_from_jax(tree, CFG, device="cpu")


def _prompts(S, seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab, (B, S)
                                                ).astype(np.int32)


def _close(got, want, rtol_max):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol_max * np.abs(want).max(), (err, np.abs(want).max())


def _jax_cache_blocks(cache):
    """``repro``'s cache pytree as one dict per block in layer order."""
    out = [dict(c) for c in cache["prefix"]]
    for g in range(CFG.n_groups):
        for pos in range(len(CFG.pattern)):
            out.append({n: np.asarray(a)[g]
                        for n, a in cache["body"][pos].items()})
    return out + [dict(c) for c in cache["suffix"]]


def _close_cache(got, want):
    want = _jax_cache_blocks(want)
    assert len(got) == len(want) == CFG.n_layers
    for kind, g, w in zip((k for k, _ in CFG.layer_specs()), got, want):
        names = ("conv", "h") if kind == "rec" else ("k", "v")
        assert set(g) == set(names) == set(w)
        for n in names:
            assert g[n].dtype == torch.float32
            _close(g[n].numpy(), w[n], RTOL_STATE)


def test_config_is_the_reduced_hybrid():
    assert [k for k, _ in CFG.layer_specs()] == ["rec", "rec", "local"] * 2
    assert (CFG.d_model, CFG.n_heads, CFG.kv_heads, CFG.dh, CFG.window,
            CFG.vocab) == (64, 4, 1, 16, 8, 256)
    assert dataclasses.asdict(reduced(get_arch("recurrentgemma-2b"))) == \
        dataclasses.asdict(CFG)


def test_prefill_and_cache_match_repro(setup):
    tree, model = setup
    tok = _prompts(PROMPT)
    want, jcache = jforward_with_cache(tree, jnp.asarray(tok), CFG,
                                       cache_len=PROMPT + GEN)
    got, cache = forward_with_cache(model, torch.from_numpy(tok), CFG,
                                    PROMPT + GEN)
    _close(got, want, RTOL_LOGITS)
    _close_cache(cache, jcache)
    assert cache[0]["conv"].shape == (B, 3, CFG.d_model)
    assert cache[0]["h"].shape == (B, CFG.d_model)
    assert cache[2]["k"].shape == (B, CFG.window, CFG.kv_heads, CFG.dh)


def test_decode_steps_match_repro_through_the_ring_wrap(setup):
    """Teacher-forced decode steps from position 8 to 15 (the window-8
    rings wrap at once): logits at every step, every cache entry after
    each step."""
    tree, model = setup
    tok = _prompts(PROMPT + GEN, seed=1)
    _, jcache = jforward_with_cache(tree, jnp.asarray(tok[:, :PROMPT]), CFG,
                                    cache_len=PROMPT + GEN)
    _, cache = forward_with_cache(model, torch.from_numpy(tok[:, :PROMPT]),
                                  CFG, PROMPT + GEN)
    for pos in range(PROMPT, PROMPT + GEN):
        step = tok[:, pos:pos + 1]
        want, jcache = jdecode_step(tree, jnp.asarray(step), jcache,
                                    jnp.asarray(pos), CFG)
        got, cache = decode_step(model, torch.from_numpy(step), cache, pos,
                                 CFG)
        assert tuple(got.shape) == (B, 1, CFG.vocab)
        _close(got, want, RTOL_LOGITS)
        _close_cache(cache, jcache)


def test_greedy_serve_steps_match_repro(setup):
    tree, model = setup
    tok = _prompts(PROMPT, seed=2)
    jl, jcache = jforward_with_cache(tree, jnp.asarray(tok), CFG,
                                     cache_len=PROMPT + GEN)
    tl, cache = forward_with_cache(model, torch.from_numpy(tok), CFG,
                                   PROMPT + GEN)
    jt = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    tt = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    for i in range(GEN - 1):
        jt, jlg, jcache = jserve_step(tree, jt, jcache,
                                      jnp.asarray(PROMPT + i), CFG)
        tt, tlg, cache = serve_step(model, tt, cache, PROMPT + i, CFG)
        _close(tlg, jlg, RTOL_LOGITS)
        assert np.array_equal(tt.numpy(), np.asarray(jt)), i


def test_training_forward_matches_repro_and_its_gradient_flows(setup):
    """The CPU training forward runs the scan's twin under autograd."""
    from repro.models import forward as jforward
    tree, model = setup
    tok = _prompts(13, seed=3)
    got = forward(model, torch.from_numpy(tok), CFG)
    _close(got.detach(), jforward(tree, jnp.asarray(tok), CFG), RTOL_LOGITS)
    got.square().mean().backward()
    g = model.blocks[0].rg["lambda"].grad
    assert g is not None and bool(torch.isfinite(g).all()) and g.any()
    model.zero_grad(set_to_none=True)


def test_decode_matches_forward_past_the_ring(setup):
    """The port on its own: prefill S-1 tokens and decode the last gives
    the full forward's last logits, at S = 2 * window + 3."""
    _, model = setup
    S = 2 * CFG.window + 3
    tok = torch.from_numpy(_prompts(S, seed=4))
    with torch.no_grad():
        full = forward(model, tok, CFG)
    _, cache = forward_with_cache(model, tok[:, :S - 1], CFG, S)
    lg, _ = decode_step(model, tok[:, S - 1:], cache, S - 1, CFG)
    _close(lg[:, 0], full[:, S - 1], RTOL_LOGITS)
    _, cache = forward_with_cache(model, tok[:, :1], CFG, S)
    for pos in range(1, S):
        lg, cache = decode_step(model, tok[:, pos:pos + 1], cache, pos, CFG)
        _close(lg[:, 0], full[:, pos], RTOL_LOGITS)


def test_init_cache_layout(setup):
    _, model = setup
    cache = init_cache(model, CFG, 3, 20)
    for (kind, _), c in zip(CFG.layer_specs(), cache):
        if kind == "rec":
            assert c["conv"].shape == (3, 3, CFG.d_model)
            assert c["h"].shape == (3, CFG.d_model)
        else:
            assert c["k"].shape == (3, CFG.window, CFG.kv_heads, CFG.dh)
        assert all(t.dtype == torch.float32 and not t.any()
                   for t in c.values())


def test_rec_forward_off_the_cpu_with_grad_raises():
    """Training ``rec`` blocks off the CPU runs the scan through the
    kernel's autograd function, which takes CUDA tensors only: a meta
    model (standing in for the card's here) raises at the scan, before
    any launch.  ``tests/test_torch_rg_lru_bwd_cuda.py`` trains on the
    card."""
    model = Transformer(CFG, device="meta")
    tok = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no Hopper kernel"):
        forward(model, tok, CFG)


def _count_twins(monkeypatch):
    calls = {"flash_attention": 0, "decode_attention": 0, "rglru_scan": 0}

    def counted(name):
        twin = getattr(ref, name + "_ref")

        def call(*a, **kw):
            calls[name] += 1
            return twin(*a, **kw)
        monkeypatch.setattr(ref, name + "_ref", call)
    for name in calls:
        counted(name)
    return calls


def test_serve_launcher_on_the_cpu(capsys, monkeypatch):
    """``python -m repro_torch.launch.serve --arch recurrentgemma-2b
    --device cpu --smoke``: one flash call per ``local`` block in the
    prefill, one decode call per ``local`` block per step, one scan per
    ``rec`` block in the prefill and in each step; no kernel launch."""
    gen = 5
    calls = _count_twins(monkeypatch)
    rec = serve.main(["--arch", "recurrentgemma-2b", "--device", "cpu",
                      "--smoke", "--gen", str(gen)])
    kinds = [k for k, _ in rec["cfg"].layer_specs()]
    n_local, n_rec = kinds.count("local"), kinds.count("rec")
    assert calls == {"flash_attention": n_local,
                     "decode_attention": n_local * (gen - 1),
                     "rglru_scan": n_rec * gen}
    assert rec["launches"] == {"flash_attention": 0, "decode_attention": 0,
                               "rglru_scan": 0}
    assert rec["tokens"].shape == (4, gen)
    assert "prefill 4x32" in capsys.readouterr().out


def test_serve_run_serves_a_given_model():
    """``serve.run(model=...)`` serves that model (one draw, several runs)
    and gives what drawing it in the run gives."""
    drawn = serve.run(arch="recurrentgemma-2b", smoke=True, device="cpu",
                      gen=4, keep_logits=True, log=None)
    model = serve.make_model(drawn["cfg"], 0, torch.device("cpu"))
    given = serve.run(model=model, gen=4, keep_logits=True, log=None)
    assert given["cfg"] == drawn["cfg"]
    assert torch.equal(given["tokens"], drawn["tokens"])
    assert torch.equal(given["logits"]["prefill"],
                       drawn["logits"]["prefill"])
    assert rg_lru.LAUNCHES == {"rglru_scan": 0}


@pytest.mark.parametrize("choice", [{"arch": "recurrentgemma-2b"},
                                    {"smoke": True}, {"device": "cpu"}])
def test_serve_run_model_rejects_a_second_choice(choice):
    """A ``model=`` serve takes its configuration and device from the
    model; naming them again raises instead of being ignored."""
    cfg = reduced(get_arch("recurrentgemma-2b"))
    model = serve.make_model(cfg, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="model="):
        serve.run(model=model, gen=2, log=None, **choice)


def test_full_recurrentgemma_2b_parameter_count():
    cfg = get_arch("recurrentgemma-2b")
    model = Transformer(cfg, device="meta")
    kinds = [k for k, _ in cfg.layer_specs()]
    assert kinds.count("rec") == 18 and kinds.count("local") == 8
    assert model.flat.numel() == 3_038_753_280
    sizes = {b.kind: sum(p.numel() for p in b.parameters())
             for b in model.blocks}
    assert sizes == {"rec": 72_115_200, "local": 53_744_640}
