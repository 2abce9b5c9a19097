"""``whisper-medium`` -- a non-causal ``attn`` encoder over (stub) frame
embeddings and ``encdec`` decoder blocks (self attention, cross attention
to the encoder's output, MLP) -- on the port's serving and
training-forward paths against ``repro`` on the CPU; its config equal to
``repro``'s; its full parameter count.  Training it:
``test_torch_cross_train``.

Models: ``configs.reduced`` (2 decoder and 2 encoder layers, d=64, 4
heads over 4 kv heads, dh 16, 16 frames; layernorm, gelu, QKV biases)
and the same with 37 frames.  ``repro``'s initial float32 parameters are
carried across by ``params_from_jax`` with every norm scale and bias and
every QKV bias seeded nonzero on both sides; the frames are ``0.1 N(0,
1)`` from numpy (``repro``'s launcher feeds zeros, which its encoder maps
to zeros).  Helpers and tolerances are ``test_torch_xattn``'s: logits
within 1e-4 of the largest |logit|, self-attention cache entries within
2e-5, the cross-attention entries and the encoder's output within 1e-5,
greedy tokens exactly, the loss within 1e-5 relative.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.launch import serve
from repro_torch.models import (Transformer, decode_step, forward,
                                forward_with_cache, init_cache, lm_loss,
                                params_from_jax)
from repro_torch.models.transformer import encode
from repro_torch.training import serve_step

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import decode_step as jdecode_step  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import forward_with_cache as jforward_with_cache  # noqa: E402
from repro.models.transformer import encode as jencode  # noqa: E402
from repro.models import lm_loss as jlm_loss  # noqa: E402
from repro.training import serve_step as jserve_step  # noqa: E402

from test_torch_xattn import (ATOL_CROSS, B, GEN, PROMPT,  # noqa: E402
                              close_cache, close_logits, leaves_held,
                              memory_for, perturbed_tree, prompts,
                              twin_counter)

ARCH = "whisper-medium"
P_FULL = 811_333_632                 # repro's init_model under eval_shape
P_ENCODER = 302_163_968
CONFIGS = {"reduced": jreduced(jget_arch(ARCH)),
           "frames37": dataclasses.replace(jreduced(jget_arch(ARCH)),
                                           cross_memory_len=37)}


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


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def setup(request):
    cfg = CONFIGS[request.param]
    tree = perturbed_tree(cfg, seed=len(request.param))
    return cfg, tree, params_from_jax(tree, cfg, device="cpu")


def test_config_equals_repros():
    got, want = get_arch(ARCH), jget_arch(ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(reduced(got)) == \
        dataclasses.asdict(jreduced(want))
    assert ARCH in ARCHS
    from repro_torch.configs.whisper_medium import DECODER_PROMPT_LEN
    from repro.configs.whisper_medium import DECODER_PROMPT_LEN as want_len
    assert DECODER_PROMPT_LEN == want_len == 448


def test_full_parameter_count():
    """Counted on the meta device: nothing is allocated."""
    model = Transformer(get_arch(ARCH), device="meta")
    assert model.flat.numel() == P_FULL
    assert sum(p.numel() for p in model.encoder.parameters()) == P_ENCODER
    assert len(model.blocks) == len(model.encoder.blocks) == 24
    assert {b.kind for b in model.blocks} == {"encdec"}
    names = [n.split(".")[0] for n, _ in model.blocks[0].named_parameters()]
    assert list(dict.fromkeys(names)) == ["norm1", "attn", "normx", "xattn",
                                          "norm2", "mlp"]


def test_params_from_jax_holds_every_leaf(setup):
    cfg, tree, model = setup
    got = leaves_held(model, tree)
    for g in range(cfg.n_groups):
        for k, sub in tree["body"][0].items():
            for leaf, a in sub.items():
                assert np.array_equal(got[f"blocks.{g}.{k}.{leaf}"],
                                      np.asarray(a)[g])
    enc = tree["encoder"]
    for i in range(cfg.encoder.n_layers):
        for k, sub in enc["body"].items():
            for leaf, a in sub.items():
                assert np.array_equal(got[f"encoder.blocks.{i}.{k}.{leaf}"],
                                      np.asarray(a)[i])
    for leaf, a in enc["final_norm"].items():
        assert np.array_equal(got[f"encoder.final_norm.{leaf}"], a)
    assert np.abs(got["blocks.1.xattn.bv"]).min() > 0


def test_encoder_matches_repro(setup):
    cfg, tree, model = setup
    frames = memory_for(cfg, 11)
    want = jencode(tree, jnp.asarray(frames), cfg)
    with torch.no_grad():
        got = encode(model, torch.from_numpy(frames), cfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL_CROSS)
    assert float(got.abs().max()) > 0.1


def test_forward_and_loss_match_repro(setup):
    """The training forward and ``lm_loss`` over encoded frames; the
    gradient reaches the encoder and the cross attention."""
    cfg, tree, model = setup
    tok = prompts(cfg, PROMPT, seed=3)
    labels = prompts(cfg, PROMPT, seed=4)
    frames = memory_for(cfg, 5)
    got = forward(model, torch.from_numpy(tok), cfg,
                  enc_frames=torch.from_numpy(frames))
    want = jforward(tree, jnp.asarray(tok), cfg,
                    enc_frames=jnp.asarray(frames))
    close_logits(got.detach(), want)
    loss = lm_loss(got, torch.from_numpy(labels))
    jloss = float(jlm_loss(want, jnp.asarray(labels)))
    assert abs(float(loss.detach()) - jloss) <= 1e-5 * abs(jloss)
    loss.backward()
    for p in (model.encoder.blocks[0].attn["wq"], model.blocks[0].xattn["bk"],
              model.blocks[1].xattn["wv"]):
        assert p.grad is not None and bool(torch.isfinite(p.grad).all())
        assert p.grad.any()
    model.zero_grad(set_to_none=True)


def test_the_frames_are_required(setup):
    cfg, _, model = setup
    tok = torch.from_numpy(prompts(cfg, 3))
    for call in (lambda: forward(model, tok, cfg),
                 lambda: forward_with_cache(model, tok, cfg, 8),
                 lambda: init_cache(model, cfg, B, 8)):
        with pytest.raises(ValueError, match="enc_frames"):
            call()


def test_prefill_and_cache_match_repro(setup):
    cfg, tree, model = setup
    tok = prompts(cfg, PROMPT)
    frames = memory_for(cfg, 6)
    want, jcache = jforward_with_cache(tree, jnp.asarray(tok), cfg,
                                       cache_len=PROMPT + GEN,
                                       enc_frames=jnp.asarray(frames))
    got, cache = forward_with_cache(model, torch.from_numpy(tok), cfg,
                                    PROMPT + GEN,
                                    enc_frames=torch.from_numpy(frames))
    close_logits(got, want)
    close_cache(cache, jcache, cfg)
    assert list(cache[0]) == ["k", "v", "xk", "xv"]
    assert cache[0]["k"].shape == (B, PROMPT + GEN, cfg.kv_heads, cfg.dh)
    assert cache[0]["xk"].shape == (B, cfg.cross_memory_len, cfg.kv_heads,
                                    cfg.dh)


def test_init_cache_encodes_the_frames(setup):
    cfg, _, model = setup
    frames = torch.from_numpy(memory_for(cfg, 7))
    cache = init_cache(model, cfg, B, 20, enc_frames=frames)
    _, filled = forward_with_cache(model, torch.from_numpy(prompts(cfg, 4)),
                                   cfg, 20, enc_frames=frames)
    for c, f in zip(cache, filled):
        assert list(c) == list(f) == ["k", "v", "xk", "xv"]
        assert torch.equal(c["xk"], f["xk"]) and \
            torch.equal(c["xv"], f["xv"])
        assert not c["k"].any() and c["k"].shape == f["k"].shape


def test_decode_steps_match_repro(setup):
    """Teacher-forced decode steps: logits and every cache entry after
    each step (self k / v written in place, xk / xv only read)."""
    cfg, tree, model = setup
    tok = prompts(cfg, PROMPT + GEN, seed=1)
    frames = memory_for(cfg, 8)
    _, jcache = jforward_with_cache(tree, jnp.asarray(tok[:, :PROMPT]), cfg,
                                    cache_len=PROMPT + GEN,
                                    enc_frames=jnp.asarray(frames))
    _, cache = forward_with_cache(model, torch.from_numpy(tok[:, :PROMPT]),
                                  cfg, PROMPT + GEN,
                                  enc_frames=torch.from_numpy(frames))
    xv = cache[1]["xv"].clone()
    for pos in range(PROMPT, PROMPT + GEN):
        step = tok[:, pos:pos + 1]
        want, jcache = jdecode_step(tree, jnp.asarray(step), jcache,
                                    jnp.asarray(pos), cfg)
        got, cache = decode_step(model, torch.from_numpy(step), cache, pos,
                                 cfg)
        assert tuple(got.shape) == (B, 1, cfg.vocab)
        close_logits(got, want)
        close_cache(cache, jcache, cfg)
    assert torch.equal(cache[1]["xv"], xv)


def test_greedy_serve_steps_match_repro(setup):
    cfg, tree, model = setup
    tok = prompts(cfg, PROMPT, seed=2)
    frames = memory_for(cfg, 9)
    jl, jcache = jforward_with_cache(tree, jnp.asarray(tok), cfg,
                                     cache_len=PROMPT + GEN,
                                     enc_frames=jnp.asarray(frames))
    tl, cache = forward_with_cache(model, torch.from_numpy(tok), cfg,
                                   PROMPT + GEN,
                                   enc_frames=torch.from_numpy(frames))
    jt = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    tt = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    for i in range(GEN - 1):
        jt, jlg, jcache = jserve_step(tree, jt, jcache,
                                      jnp.asarray(PROMPT + i), cfg)
        tt, tlg, cache = serve_step(model, tt, cache, PROMPT + i, cfg)
        close_logits(tlg, jlg)
        assert np.array_equal(tt.numpy(), np.asarray(jt)), i


def test_serve_launcher_on_the_cpu(monkeypatch):
    """``python -m repro_torch.launch.serve --arch whisper-medium --device
    cpu --smoke`` with the launcher's zero frames: in the prefill one
    flash call per encoder layer and two per decoder layer (self, cross),
    in each decode step after the first two decode calls per decoder
    layer, each the twin."""
    calls = twin_counter(monkeypatch)
    gen = 4
    rec = serve.main(["--arch", ARCH, "--device", "cpu", "--smoke",
                      "--gen", str(gen)])
    cfg = rec["cfg"]
    n, ne = cfg.n_layers, cfg.encoder.n_layers
    assert (n, ne) == (2, 2)
    assert calls == {"flash_attention": ne + 2 * n,
                     "decode_attention": 2 * n * (gen - 1)}
    assert rec["launches"] == {"flash_attention": 0, "decode_attention": 0,
                               "rglru_scan": 0}
    assert rec["tokens"].shape == (4, gen)


def test_serve_run_feeds_the_frames(setup):
    """``serve.run(model=..., enc_frames=...)`` serves what
    ``forward_with_cache`` gives with those frames; the launcher's zero
    frames serve other logits."""
    cfg, _, model = setup
    frames = torch.from_numpy(memory_for(cfg, 10, batch=4))
    fed = serve.run(model=model, gen=3, prompt_len=5, enc_frames=frames,
                    keep_logits=True, log=None)
    zero = serve.run(model=model, gen=3, prompt_len=5, keep_logits=True,
                     log=None)
    want, _ = forward_with_cache(model, fed["prompts"], cfg, 8,
                                 enc_frames=frames)
    assert torch.equal(fed["logits"]["prefill"], want)
    gap = (fed["logits"]["prefill"] - zero["logits"]["prefill"]).abs().max()
    assert float(gap) > 1e-3
    with pytest.raises(ValueError):
        serve.run(model=model, gen=2, memory=frames, log=None)
