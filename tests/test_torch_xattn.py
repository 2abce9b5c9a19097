"""``llama-3.2-vision-11b`` -- ``attn`` blocks and every fifth an ``xattn``
block, cross attention to a (stub) image memory behind two tanh gates --
on the port's serving and training-forward paths against ``repro`` on the
CPU; its config equal to ``repro``'s; its full parameter count.

Models: ``configs.reduced`` (10 layers, two groups of 4 ``attn`` + 1
``xattn``, d=64, 4 query heads over 4 kv heads, dh 16, a 16-row memory)
and the same config keeping the real model's grouping of 4 query heads a
kv head (8 over 2) with a 37-row memory.  ``repro``'s initial float32
parameters are carried across by ``params_from_jax`` with every norm
scale given seeded nonzero values and the gates ``gate_x`` / ``gate_m``
seeded around 0.5 and -0.7 on both sides: ``repro`` starts the gates at
zero, where an ``xattn`` block adds nothing.  The memory is ``0.1 N(0,
1)`` from numpy.  B = 2, prompt 9, gen 6.  Tolerances (the serving
tests'): logits within 1e-4 of the largest |logit|, self-attention cache
entries within 2e-5, the cross-attention entries within 1e-5, greedy
tokens exactly, the loss within 1e-5 relative.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.models import (Transformer, decode_step, forward,
                                forward_with_cache, init_cache, init_model,
                                lm_loss, params_from_jax)
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

ARCH = "llama-3.2-vision-11b"
P_FULL = 9_775_157_264               # repro's init_model under eval_shape
RTOL_LOGITS = 1e-4
ATOL_CACHE = 2e-5
ATOL_CROSS = 1e-5                    # xk / xv and the encoder's output
B, PROMPT, GEN = 2, 9, 6
# the reduced configs: repro's, and one keeping G = 4 with a 37-row memory
CONFIGS = {"reduced": jreduced(jget_arch(ARCH)),
           "g4-mem37": dataclasses.replace(jreduced(jget_arch(ARCH)),
                                           n_heads=8, kv_heads=2,
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


def perturbed_tree(cfg, seed):
    """``repro``'s initial float32 parameters with the norm scales and
    biases, the QKV biases and the ``xattn`` gates seeded nonzero."""
    tree = jax.device_get(jinit(jax.random.PRNGKey(seed), cfg,
                                dtype=jnp.float32))
    rng = np.random.default_rng(seed + 100)

    def bump(path, x):
        name = str(getattr(path[-1], "key", ""))
        x = np.asarray(x, np.float32)
        if name in ("scale", "bias", "bq", "bk", "bv"):
            x = x + 0.3 * rng.standard_normal(x.shape)
        elif name in ("gate_x", "gate_m"):
            x = (0.5 if name == "gate_x" else -0.7) + \
                0.1 * rng.standard_normal(x.shape)
        return np.asarray(x, np.float32)
    return jax.tree_util.tree_map_with_path(bump, tree)


def memory_for(cfg, seed, batch=B):
    """``0.1 N(0, 1)`` rows [batch, cross_memory_len, d_model] (numpy)."""
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal(
        (batch, cfg.cross_memory_len, cfg.d_model))).astype(np.float32)


def prompts(cfg, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)
                                                ).astype(np.int32)


def close_logits(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= RTOL_LOGITS * np.abs(want).max(), err


def close_cache(got, want, cfg):
    """The port's per-layer cache against ``repro``'s stacked body: every
    entry, k / v within ATOL_CACHE, xk / xv within ATOL_CROSS."""
    P = len(cfg.pattern)
    blocks = [{n: np.asarray(a)[g] for n, a in want["body"][pos].items()}
              for g in range(cfg.n_groups) for pos in range(P)]
    assert len(got) == len(blocks) == cfg.n_layers
    for g, w in zip(got, blocks):
        assert set(g) == set(w)
        for n in w:
            np.testing.assert_allclose(
                g[n].numpy(), w[n], rtol=0,
                atol=ATOL_CROSS if n in ("xk", "xv") else ATOL_CACHE)


def leaves_held(model, tree):
    """Every leaf of ``repro``'s tree, unstacked, equals the port's
    parameter of the same name, and the two hold the same count."""
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    flat = jax.tree_util.tree_leaves(tree)
    assert sum(np.size(a) for a in flat) == model.flat.numel()
    return got


def twin_counter(monkeypatch):
    """Count the attention twins' calls (the CPU's stand-ins for
    launches)."""
    calls = {"flash_attention": 0, "decode_attention": 0}
    for name in calls:
        twin = getattr(ref, name + "_ref")

        def call(*a, _twin=twin, _name=name, **kw):
            calls[_name] += 1
            return _twin(*a, **kw)
        monkeypatch.setattr(ref, name + "_ref", call)
    return calls


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


def test_full_parameter_count():
    """Counted on the meta device: nothing is allocated."""
    cfg = get_arch(ARCH)
    model = Transformer(cfg, device="meta")
    assert model.flat.numel() == P_FULL
    assert len(model.blocks) == 40
    assert [b.kind for b in model.blocks[:5]] == ["attn"] * 4 + ["xattn"]
    xattn = sum(p.numel() for b in model.blocks if b.kind == "xattn"
                for p in b.parameters())
    assert xattn == 1_744_896_016


def test_block_leaves_carry_repros_names():
    """repro's names; the scalar gates, the block's own parameters, come
    first (a module's own parameters precede its children's), the
    sub-dicts then follow ``init_block``'s order."""
    cfg = CONFIGS["reduced"]
    names = [n for n, _ in Transformer(cfg, device="meta").blocks[4]
             .named_parameters()]
    assert [n.split(".")[0] for n in names] == \
        ["gate_x", "gate_m", "normx"] + ["xattn"] * 4 + ["norm2"] + \
        ["mlp"] * 3


def test_init_model_starts_the_gates_at_zero():
    model = init_model(CONFIGS["reduced"], 3, device="cpu")
    for blk in model.blocks:
        if blk.kind == "xattn":
            assert float(blk.gate_x.detach()) == 0.0
            assert float(blk.gate_m.detach()) == 0.0
            assert blk.xattn["wq"].abs().max() > 0


def test_params_from_jax_holds_every_leaf(setup):
    cfg, tree, model = setup
    got = leaves_held(model, tree)
    P = len(cfg.pattern)
    for g in range(cfg.n_groups):
        for pos in range(P):
            i = g * P + pos
            for k, sub in tree["body"][pos].items():
                if isinstance(sub, dict):
                    for leaf, a in sub.items():
                        assert np.array_equal(got[f"blocks.{i}.{k}.{leaf}"],
                                              np.asarray(a)[g])
                else:
                    assert np.array_equal(got[f"blocks.{i}.{k}"],
                                          np.asarray(sub)[g])
                    assert got[f"blocks.{i}.{k}"].shape == ()
                    assert got[f"blocks.{i}.{k}"] != 0
    assert np.array_equal(got["embed.table"], tree["embed"]["table"])
    assert np.array_equal(got["lm_head.w"], tree["lm_head"]["w"])


def test_forward_and_loss_match_repro(setup):
    """The training forward and ``lm_loss`` with the memory; the gradient
    reaches both gates and the cross attention's projections."""
    cfg, tree, model = setup
    tok = prompts(cfg, PROMPT, seed=3)
    labels = prompts(cfg, PROMPT, seed=4)
    mem = memory_for(cfg, 5)
    got = forward(model, torch.from_numpy(tok), cfg,
                  memory=torch.from_numpy(mem))
    want = jforward(tree, jnp.asarray(tok), cfg, memory=jnp.asarray(mem))
    close_logits(got.detach(), want)
    loss = lm_loss(got, torch.from_numpy(labels))
    jloss = float(jlm_loss(want, jnp.asarray(labels)))
    assert abs(float(loss.detach()) - jloss) <= 1e-5 * abs(jloss)
    loss.backward()
    blk = model.blocks[4]
    for p in (blk.gate_x, blk.gate_m, blk.xattn["wk"], blk.xattn["wv"]):
        assert p.grad is not None and bool(torch.isfinite(p.grad).all())
        assert p.grad.any()
    model.zero_grad(set_to_none=True)


def test_the_memory_is_required(setup):
    cfg, _, model = setup
    tok = torch.from_numpy(prompts(cfg, 3))
    for call in (lambda: forward(model, tok, cfg),
                 lambda: forward_with_cache(model, tok, cfg, 8),
                 lambda: init_cache(model, cfg, B, 8)):
        with pytest.raises(ValueError, match="memory"):
            call()


def test_prefill_and_cache_match_repro(setup):
    cfg, tree, model = setup
    tok = prompts(cfg, PROMPT)
    mem = memory_for(cfg, 6)
    want, jcache = jforward_with_cache(tree, jnp.asarray(tok), cfg,
                                       cache_len=PROMPT + GEN,
                                       memory=jnp.asarray(mem))
    got, cache = forward_with_cache(model, torch.from_numpy(tok), cfg,
                                    PROMPT + GEN,
                                    memory=torch.from_numpy(mem))
    close_logits(got, want)
    close_cache(cache, jcache, cfg)
    assert cache[4]["xk"].shape == (B, cfg.cross_memory_len, cfg.kv_heads,
                                    cfg.dh)
    assert set(cache[4]) == {"xk", "xv"}


def test_init_cache_projects_the_memory(setup):
    """``init_cache``'s cross entries equal the prefill's (``repro``
    precomputes them the same way); the self entries are zeros."""
    cfg, _, model = setup
    mem = torch.from_numpy(memory_for(cfg, 7))
    cache = init_cache(model, cfg, B, 20, memory=mem)
    _, filled = forward_with_cache(model, torch.from_numpy(prompts(cfg, 4)),
                                   cfg, 20, memory=mem)
    for c, f in zip(cache, filled):
        assert set(c) == set(f)
        for n in c:
            if n in ("xk", "xv"):
                assert torch.equal(c[n], f[n])
            else:
                assert c[n].shape == f[n].shape and not c[n].any()


def test_decode_steps_match_repro(setup):
    """Teacher-forced decode steps: logits and every cache entry after
    each step; the cross entries are never written."""
    cfg, tree, model = setup
    tok = prompts(cfg, PROMPT + GEN, seed=1)
    mem = memory_for(cfg, 8)
    _, jcache = jforward_with_cache(tree, jnp.asarray(tok[:, :PROMPT]), cfg,
                                    cache_len=PROMPT + GEN,
                                    memory=jnp.asarray(mem))
    _, cache = forward_with_cache(model, torch.from_numpy(tok[:, :PROMPT]),
                                  cfg, PROMPT + GEN,
                                  memory=torch.from_numpy(mem))
    xk = cache[4]["xk"].clone()
    for pos in range(PROMPT, PROMPT + GEN):
        step = tok[:, pos:pos + 1]
        want, jcache = jdecode_step(tree, jnp.asarray(step), jcache,
                                    jnp.asarray(pos), cfg)
        got, cache = decode_step(model, torch.from_numpy(step), cache, pos,
                                 cfg)
        assert tuple(got.shape) == (B, 1, cfg.vocab)
        close_logits(got, want)
        close_cache(cache, jcache, cfg)
    assert torch.equal(cache[4]["xk"], xk)


def test_greedy_serve_steps_match_repro(setup):
    cfg, tree, model = setup
    tok = prompts(cfg, PROMPT, seed=2)
    mem = memory_for(cfg, 9)
    jl, jcache = jforward_with_cache(tree, jnp.asarray(tok), cfg,
                                     cache_len=PROMPT + GEN,
                                     memory=jnp.asarray(mem))
    tl, cache = forward_with_cache(model, torch.from_numpy(tok), cfg,
                                   PROMPT + GEN,
                                   memory=torch.from_numpy(mem))
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
    """``python -m repro_torch.launch.serve --arch llama-3.2-vision-11b
    --device cpu --smoke`` with the launcher's zero memory: one flash
    call per layer in the prefill (self attention, or the ``xattn``
    block's cross attention) and one decode call per layer per step after
    the first, each the twin."""
    calls = twin_counter(monkeypatch)
    gen = 4
    rec = serve.main(["--arch", ARCH, "--device", "cpu", "--smoke",
                      "--gen", str(gen)])
    n = rec["cfg"].n_layers
    assert n == 10
    assert calls == {"flash_attention": n, "decode_attention": n * (gen - 1)}
    assert rec["launches"] == {"flash_attention": 0, "decode_attention": 0,
                               "rglru_scan": 0}
    assert rec["tokens"].shape == (4, gen)


def test_serve_run_feeds_the_memory(setup):
    """``serve.run(model=..., memory=...)`` serves what
    ``forward_with_cache`` and ``serve_step`` give with that memory; with
    the gates nonzero, the launcher's zero memory serves other logits."""
    cfg, _, model = setup
    mem = torch.from_numpy(memory_for(cfg, 10, batch=4))
    fed = serve.run(model=model, gen=3, prompt_len=5, memory=mem,
                    keep_logits=True, log=None)
    zero = serve.run(model=model, gen=3, prompt_len=5, keep_logits=True,
                     log=None)
    want, _ = forward_with_cache(model, fed["prompts"], cfg, 8, memory=mem)
    assert torch.equal(fed["logits"]["prefill"], want)
    gap = (fed["logits"]["prefill"] - zero["logits"]["prefill"]).abs().max()
    assert float(gap) > 1e-3
    with pytest.raises(ValueError):
        serve.run(model=model, gen=2, enc_frames=mem, log=None)
