"""xLSTM (``mlstm`` + ``slstm`` blocks): the port's cells, prefill,
decode and ``serve_step`` against ``repro`` on the CPU, and the serving
launcher.

Cells: d=64, 4 heads (dh 16), ``repro``'s own initial parameters
(``init_mlstm_block`` / ``init_slstm_block``, float32) with every bias
given seeded nonzero values, and seeded nonzero starting states.  Model:
``configs.reduced(xlstm-125m)`` -- 8 layers, (mlstm, mlstm, mlstm, slstm)
x 2, d=64, 4 heads, mLSTM chunk 8, vocab 256 -- with ``repro``'s initial
parameters (norm scales and biases, the gate biases, seeded nonzero)
carried across by ``params_from_jax``.  B = 2, prompt 13 (a ragged last
chunk), gen 6.  Tolerances: logits within 1e-4 of the largest |logit|
(the serving bound); every cell output, state and cache entry within
1e-5 of its own largest |value| (the recurrent blocks' bound,
``tests/test_torch_recurrent.py``); greedy tokens exactly.

The cache is held block by block, each block fed ``repro``'s own input
to it: this model is ill-conditioned in float32 -- ``repro`` itself,
given its parameters with one-ulp relative noise, moves the deep blocks'
states by more than the 1e-5 bound, more each block deeper -- so a
whole-model comparison of the deep blocks' states measures the model's
conditioning, not the port.  The logits (1e-4) are held through the
whole model.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rg_lru
from repro_torch.launch import serve
from repro_torch.models import (Transformer, decode_step, forward,
                                forward_with_cache, init_cache, init_model,
                                lm_loss, params_from_jax)
from repro_torch.models import recurrent as R
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
from repro.models import recurrent as JR  # noqa: E402
from repro.training import serve_step as jserve_step  # noqa: E402

CFG = jreduced(jget_arch("xlstm-125m"))
RTOL_LOGITS = 1e-4               # of the largest |logit|
RTOL_STATE = 1e-5                # of each state's largest |value|
B, PROMPT, GEN = 2, 13, 6
D, H = 64, 4
DH = D // H
NAMES = {"mlstm": ("C", "n", "m"), "slstm": ("c", "n", "h", "m")}


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


def _close(got, want, rtol_max):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol_max * np.abs(want).max(), (err, np.abs(want).max())


def _np(tree):
    return {k: np.asarray(v, np.float32) for k, v in tree.items()}


def _nonzero_biases(tree, seed):
    """Seeded nonzero values for every bias leaf (``b_*``) of a cell."""
    rng = np.random.default_rng(seed)
    out = dict(tree)
    for k, v in tree.items():
        if k.startswith("b_"):
            out[k] = (v + 0.5 * rng.standard_normal(v.shape)).astype(
                np.float32)
    return out


def _x(S, seed=0):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)


@pytest.fixture(scope="module")
def cells():
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    m = _nonzero_biases(_np(JR.init_mlstm_block(k1, D, H, jnp.float32)), 1)
    s = _nonzero_biases(_np(JR.init_slstm_block(k2, D, H, jnp.float32)), 2)
    return m, s


def _mstate(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, DH, DH)).astype(np.float32),
            rng.standard_normal((B, H, DH)).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32))


def _sstate(seed):
    rng = np.random.default_rng(seed)
    c, n, h = (rng.standard_normal((B, H, DH)).astype(np.float32)
               for _ in range(3))
    return (c, np.abs(n) + 1.0, h, rng.standard_normal((B, H, DH)).astype(
        np.float32))


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _states_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), w, RTOL_STATE)


def test_cell_shapes_are_repros(cells):
    m, s = cells
    assert {k: v.shape for k, v in m.items()} == R.mlstm_shapes(D, H)
    assert list(m) == list(R.mlstm_shapes(D, H))
    assert {k: v.shape for k, v in s.items()} == R.slstm_shapes(D, H)
    assert list(s) == list(R.slstm_shapes(D, H))


@pytest.mark.parametrize("S,chunk", [(13, 8), (16, 8), (5, 8), (1, 8)])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunkwise_matches_repro(cells, S, chunk, with_state):
    """Ragged S (padded steps pass the state through), whole chunks, one
    chunk shorter than the chunk size, one step; from zero and from a
    nonzero state."""
    m, _ = cells
    x = _x(S, seed=S)
    st = _mstate(7) if with_state else None
    want, wstate = JR.mlstm_chunkwise(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in m.items()}, H,
        chunk=chunk, state=None if st is None else tuple(map(jnp.asarray,
                                                             st)))
    got, gstate = R.mlstm_chunkwise(
        torch.from_numpy(x), _t(m), H, chunk=chunk,
        state=None if st is None else tuple(map(torch.from_numpy, st)))
    _close(got, want, RTOL_STATE)
    _states_close(gstate, [np.asarray(a) for a in wstate])


def test_mlstm_decode_step_matches_repro(cells):
    m, _ = cells
    x = _x(1, seed=11)
    st = _mstate(8)
    want, wstate = JR.mlstm_decode_step(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in m.items()}, H,
        tuple(map(jnp.asarray, st)))
    got, gstate = R.mlstm_decode_step(torch.from_numpy(x), _t(m), H,
                                      tuple(map(torch.from_numpy, st)))
    _close(got, want, RTOL_STATE)
    _states_close(gstate, [np.asarray(a) for a in wstate])


def test_mlstm_decode_step_continues_the_chunkwise_state(cells):
    """The port on its own: chunkwise over S tokens equals chunkwise over
    S - 1 then one decode step (last output and state)."""
    m, _ = cells
    x = torch.from_numpy(_x(10, seed=12))
    p = _t(m)
    full, fstate = R.mlstm_chunkwise(x, p, H, chunk=4)
    _, st = R.mlstm_chunkwise(x[:, :9], p, H, chunk=4)
    last, dstate = R.mlstm_decode_step(x[:, 9:], p, H, st)
    _close(last[:, 0], full[:, 9].numpy(), RTOL_STATE)
    _states_close(dstate, [t.numpy() for t in fstate])


@pytest.mark.parametrize("S", [1, 9])
@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_scan_matches_repro(cells, S, with_state):
    _, s = cells
    x = _x(S, seed=20 + S)
    st = _sstate(9) if with_state else None
    want, wstate = JR.slstm_scan(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in s.items()}, H,
        state=None if st is None else tuple(map(jnp.asarray, st)))
    got, gstate = R.slstm_scan(
        torch.from_numpy(x), _t(s), H,
        state=None if st is None else tuple(map(torch.from_numpy, st)))
    _close(got, want, RTOL_STATE)
    _states_close(gstate, [np.asarray(a) for a in wstate])


def test_init_states_are_repros():
    for got, want in zip(R.mlstm_init_state(B, H, DH, "cpu"),
                         JR.mlstm_init_state(B, H, DH)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(R.slstm_init_state(B, H, DH, "cpu"),
                         JR.slstm_init_state(B, H, DH)):
        assert np.array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ the model
def _perturbed_tree(seed=0, cfg=CFG):
    """``repro``'s initial float32 parameters of the reduced model (or
    ``cfg``), with norm scales, norm biases and the cells' biases seeded
    nonzero."""
    tree = jax.device_get(jinit(jax.random.PRNGKey(seed), cfg,
                                dtype=jnp.float32))
    rng = np.random.default_rng(seed + 100)

    def bump(path, x):
        name = str(path[-1].key) if hasattr(path[-1], "key") else ""
        x = np.asarray(x, np.float32)
        if name in ("scale", "bias") or name.startswith("b_"):
            return (x + 0.3 * rng.standard_normal(x.shape)).astype(
                np.float32)
        return x
    return jax.tree_util.tree_map_with_path(bump, tree)


@pytest.fixture(scope="module")
def setup():
    tree = _perturbed_tree()
    return tree, params_from_jax(tree, CFG, device="cpu")


def _prompts(S, seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab, (B, S)
                                                ).astype(np.int32)


def test_config_is_the_reduced_xlstm():
    assert [k for k, _ in CFG.layer_specs()] == \
        ["mlstm", "mlstm", "mlstm", "slstm"] * 2
    assert (CFG.d_model, CFG.n_heads, CFG.vocab, CFG.mlstm_chunk) == \
        (64, 4, 256, 8)
    assert dataclasses.asdict(reduced(get_arch("xlstm-125m"))) == \
        dataclasses.asdict(CFG)


def test_parameters_carry_across(setup):
    tree, model = setup
    blk = model.blocks[3]
    assert blk.kind == "slstm" and not hasattr(blk, "mlp")
    want = np.asarray(tree["body"][3]["cell"]["r"])[0]
    assert np.array_equal(blk.cell["r"].detach().numpy(), want)
    want = np.asarray(tree["body"][0]["cell"]["b_f"])[1]
    assert np.array_equal(model.blocks[4].cell["b_f"].detach().numpy(),
                          want)


def _jax_blocks(tree):
    """``repro``'s parameters as one dict per block in layer order."""
    out = []
    for g in range(CFG.n_groups):
        for pos in range(len(CFG.pattern)):
            out.append(jax.tree.map(lambda a: jnp.asarray(a)[g],
                                    tree["body"][pos]))
    return out


def test_prefill_matches_repro(setup):
    tree, model = setup
    tok = _prompts(PROMPT)
    want, _ = jforward_with_cache(tree, jnp.asarray(tok), CFG,
                                  cache_len=PROMPT + GEN)
    got, cache = forward_with_cache(model, torch.from_numpy(tok), CFG,
                                    PROMPT + GEN)
    _close(got, want, RTOL_LOGITS)
    assert len(cache) == CFG.n_layers
    for (kind, _), c in zip(CFG.layer_specs(), cache):
        assert set(c) == set(NAMES[kind])
    assert cache[0]["C"].shape == (B, H, DH, DH)
    assert cache[3]["h"].shape == (B, H, DH)


def test_each_block_prefill_and_decode_match_repro(setup):
    """Block by block, each fed ``repro``'s input to it: the prefill's
    output and cache entry, then three decode steps' outputs and cache
    entries from ``repro``'s cache."""
    from repro.models import layers as JL
    from repro.models.kv_cache import apply_block_decode, block_prefill
    from repro_torch.models.transformer import apply_block
    tree, model = setup
    tok = _prompts(PROMPT + 3, seed=6)
    h = JL.embed(jnp.asarray(tok[:, :PROMPT]), tree["embed"])
    steps = [JL.embed(jnp.asarray(tok[:, p:p + 1]), tree["embed"])
             for p in range(PROMPT, PROMPT + 3)]
    pos = jnp.arange(PROMPT)
    for i, (p, blk) in enumerate(zip(_jax_blocks(tree), model.blocks)):
        names = NAMES[blk.kind]
        want, jc = block_prefill(h, p, blk.kind, CFG, memory=None,
                                 positions=pos, Lc=PROMPT + 3)
        with torch.no_grad():
            got, state = apply_block(torch.from_numpy(np.asarray(h)), blk,
                                     blk.kind, CFG,
                                     positions=torch.arange(PROMPT),
                                     attend=None)
        _close(got, want, RTOL_STATE)
        _states_close(state, [np.asarray(jc[n]) for n in names])
        for t, x in enumerate(steps):
            wx, jc = apply_block_decode(x, p, jc, blk.kind, CFG,
                                        jnp.asarray(PROMPT + t))
            with torch.no_grad():
                gx, state = apply_block(
                    torch.from_numpy(np.asarray(x)), blk, blk.kind, CFG,
                    positions=torch.full((1,), PROMPT + t), attend=None,
                    state=state)
            _close(gx, wx, RTOL_STATE)
            _states_close(state, [np.asarray(jc[n]) for n in names])
            steps[t] = wx
        h = want


def test_decode_steps_match_repro(setup):
    """Teacher-forced decode steps through the whole model: logits at
    every step (the cache, block by block, above)."""
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


def test_training_forward_and_loss_match_repro(setup):
    """``forward`` and ``lm_loss`` against ``repro``'s, and the gradient
    reaches every cell's leaves."""
    tree, model = setup
    tok = _prompts(PROMPT, seed=3)
    labels = _prompts(PROMPT, seed=4)
    got = forward(model, torch.from_numpy(tok), CFG)
    want = jforward(tree, jnp.asarray(tok), CFG)
    _close(got.detach(), want, RTOL_LOGITS)
    loss = lm_loss(got, torch.from_numpy(labels))
    jloss = float(jlm_loss(want, jnp.asarray(labels)))
    assert abs(float(loss.detach()) - jloss) <= 1e-5 * abs(jloss)
    loss.backward()
    for i in (0, 3):
        for name, p in model.blocks[i].cell.items():
            assert p.grad is not None and bool(torch.isfinite(p.grad).all())
            assert p.grad.any(), (i, name)
    model.zero_grad(set_to_none=True)


def test_decode_matches_forward(setup):
    """The port on its own: the prefill of 1 token then decode steps
    give the full forward's logits at every position (S = 3 chunks)."""
    _, model = setup
    S = 3 * CFG.mlstm_chunk
    tok = torch.from_numpy(_prompts(S, seed=5))
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
        assert set(c) == set(NAMES[kind])
        for n, t in c.items():
            assert t.dtype == torch.float32
            if kind == "mlstm" and n == "m":
                assert t.shape == (3, H) and bool((t == -1e30).all())
                continue
            assert not t.any()
        if kind == "mlstm":
            assert c["C"].shape == (3, H, DH, DH)
            assert c["n"].shape == (3, H, DH)
        else:
            assert all(c[n].shape == (3, H, DH) for n in NAMES[kind])


def test_init_model_follows_repros_scheme():
    """Forget biases three, input biases zero, the sLSTM's recurrent
    weights 0.3 N(0, 1/H), dense weights N(0, 1/fan_in)."""
    cfg = dataclasses.replace(CFG, d_model=256, n_heads=4, head_dim=64)
    model = init_model(cfg, 0, device="cpu")
    m, s = model.blocks[0].cell, model.blocks[3].cell
    assert torch.equal(m["b_f"], torch.full((4,), 3.0))
    assert not m["b_i"].any() and not s["b_in"].any()
    assert abs(float(s["r"].std()) - 0.3 / 2) < 5e-3
    assert abs(float(m["wq"].std()) - 1 / 16) < 2e-3
    assert s["r"].shape == (4, 64, 256)


def test_full_xlstm_parameter_count():
    """``xlstm-125m`` whole, counted on the meta device (nothing
    allocated): 114,510,408 parameters, as ``repro``'s init."""
    model = Transformer(get_arch("xlstm-125m"), device="meta")
    assert model.flat.numel() == 114_510_408
    assert [b.kind for b in model.blocks] == \
        ["mlstm", "mlstm", "mlstm", "slstm"] * 3


def test_serve_launcher_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve --arch xlstm-125m --device cpu
    --smoke``: no attention or scan kernel on the path."""
    for mod in (fa, da, rg_lru):
        mod.reset_launches()
    rec = serve.main(["--arch", "xlstm-125m", "--device", "cpu", "--smoke",
                      "--gen", "4"])
    assert rec["cfg"].name == "xlstm-125m-smoke"
    assert rec["launches"] == {"flash_attention": 0, "decode_attention": 0,
                               "rglru_scan": 0}
    assert rec["tokens"].shape == (4, 4)
    assert "prefill 4x32" in capsys.readouterr().out


# ------------------------------------------------------------ training
# One pattern group of the reduced model (mlstm x 3, slstm) is held whole
# against jax.grad; the full reduced model's 8 blocks are held block by
# block, each fed repro's input to it and a seeded upstream gradient, and
# whole against the exact gradient (the port's code in float64): through 8
# blocks the float32 gradient is ill-conditioned, repro's own float32
# gradient as far from the exact one as the port's, so the whole model is
# held to repro's distance rather than to repro.
GROUP = dataclasses.replace(CFG, n_layers=len(CFG.pattern))


@pytest.fixture(scope="module")
def group():
    tree = _perturbed_tree(cfg=GROUP)
    return tree, params_from_jax(tree, GROUP, device="cpu")


@functools.lru_cache(maxsize=None)
def _jit_value_and_grad(cfg):
    """``jax.value_and_grad`` of ``repro``'s loss, jitted once for every
    case of the module (as ``repro``'s training step runs it)."""
    from repro.training.train_loop import make_loss_fn as jmake_loss
    return jax.jit(jax.value_and_grad(jmake_loss(cfg)))


def _flat(tree, cfg):
    """``repro`` tree (parameters or gradients) -> the port's flat
    layout."""
    return params_from_jax(jax.device_get(tree), cfg, device="cpu").flat


def _leaves_close(got, want, model, rtol_max):
    """Every leaf of the flat vectors ``got`` and ``want`` (the port's
    layout) within ``rtol_max`` of that leaf's largest |value|."""
    got, want = got.detach().double(), want.detach().double()
    off = 0
    for name, p in model.named_parameters():
        n = p.numel()
        g, w = got[off:off + n], want[off:off + n]
        err = float((g - w).abs().max())
        assert err <= rtol_max * float(w.abs().max()), (name, err)
        off += n
    assert off == want.numel()


@pytest.mark.parametrize("seed", [6, 9])
def test_gradients_match_jax_grad(group, seed):
    """The backward through both cells, one pattern group whole: every
    leaf's gradient (each cell's, the norms', the embedding's and the
    head's) against ``jax.grad`` of ``repro``'s loss, within 1e-4 of that
    leaf's largest |g|; a ragged last chunk (13 tokens, chunk 8)."""
    from repro_torch.training import make_loss_fn
    tree, model = group
    tok, lab = _prompts(PROMPT, seed=seed), _prompts(PROMPT, seed=seed + 1)
    jl, jg = _jit_value_and_grad(GROUP)(
        tree, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)})
    loss = make_loss_fn(GROUP)(model, {"tokens": torch.from_numpy(tok),
                                       "labels": torch.from_numpy(lab)})
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    _leaves_close(torch.cat([g.reshape(-1) for g in grads]),
                  _flat(jg, GROUP), model, RTOL_LOGITS)


def test_each_block_backward_matches_repro(setup):
    """The full reduced model block by block: each block fed ``repro``'s
    input to it (13 tokens, a ragged chunk) and a seeded upstream
    gradient; the gradients of its input and of every leaf against
    ``jax.vjp`` of ``repro``'s block, within 1e-4 of each one's largest
    |g|."""
    from repro.models import layers as JL
    from repro.models.transformer import apply_block_train as japply
    from repro_torch.models.transformer import apply_block_train
    tree, model = setup
    tok = _prompts(PROMPT, seed=10)
    h = JL.embed(jnp.asarray(tok), tree["embed"])
    pos = jnp.arange(PROMPT)
    rng = np.random.default_rng(11)
    for i, (p, blk) in enumerate(zip(_jax_blocks(tree), model.blocks)):
        gy = rng.standard_normal(h.shape).astype(np.float32)
        want, vjp = jax.vjp(lambda x, q, kind=blk.kind: japply(
            x, q, kind, CFG, positions=pos), h, p)
        jx, jp = vjp(jnp.asarray(gy))
        x = torch.from_numpy(np.array(h)).requires_grad_(True)
        got = apply_block_train(x, blk, blk.kind, CFG,
                                positions=torch.arange(PROMPT))
        _close(got.detach(), want, RTOL_STATE)
        leaves = [blk.get_parameter(n) for n, _ in blk.named_parameters()]
        grads = torch.autograd.grad((got * torch.from_numpy(gy)).sum(),
                                    [x, *leaves])
        _close(grads[0], jx, RTOL_LOGITS)
        for (name, _), g in zip(blk.named_parameters(), grads[1:]):
            sub, leaf = name.split(".")
            _close(g, jp[sub][leaf], RTOL_LOGITS)
        h = want


@pytest.mark.parametrize("mode,n_micro", [("example", 1), ("microbatch", 2)])
def test_dp_gradients_match_repro(group, mode, n_micro):
    """DP-SGD's gradients on one pattern group against ``repro``'s
    ``dp_gradients``: per-example (``example``) or per-microbatch norms
    (``grad_norm_mean`` / ``grad_norm_max``) and the loss within 1e-5
    relative, the same clip decisions, and the clipped mean gradient leaf
    by leaf within 1e-4 of each leaf's largest |g|."""
    from repro.training.dp_sgd import dp_gradients as jdp_gradients
    from repro.training.train_loop import make_loss_fn as jmake_loss
    from repro_torch.training import dp_gradients, make_loss_fn
    tree, model = group
    rng = np.random.default_rng(8)
    tok = rng.integers(0, CFG.vocab, (4, PROMPT + 1)).astype(np.int32)
    tok, lab = tok[:, :-1], tok[:, 1:]
    jg, jm = jax.jit(functools.partial(
        jdp_gradients, jmake_loss(GROUP), clip=1.0, mode=mode,
        n_micro=n_micro))(
        tree, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
        jax.random.PRNGKey(0))
    tg, tm = dp_gradients(
        make_loss_fn(GROUP), model,
        {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)},
        torch.Generator().manual_seed(0), clip=1.0, mode=mode,
        n_micro=n_micro)
    for k in ("grad_norm_mean", "grad_norm_max", "loss_mean"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    assert float(tm["clip_frac"]) == float(jm["clip_frac"])
    _leaves_close(torch.cat([g.reshape(-1) for g in tg.values()]),
                  _flat(jg, GROUP), model, RTOL_LOGITS)


def test_whole_model_gradients_as_close_to_exact_as_repros(setup):
    """The full reduced model whole, on 4 seeded batches: the port's
    float32 gradient no further from the exact one (the port's code in
    float64, ``repro_torch.fp.float64``) than 4x ``repro``'s float32
    gradient, |g - exact| / |exact| summed over the batches (one batch's
    ratio is heavy-tailed either way: a rounding can put a position on
    the other side of a stabiliser's max); ``repro``'s gradient within 5%
    of the exact one on each batch (it is 4e-5 to 9e-3 here), so the
    float64 run computes ``repro``'s function.  ``repro``'s gradient is
    jitted once for the 4 batches, as its training step runs it."""
    from repro_torch.fp import float64
    from repro_torch.training import make_loss_fn
    tree, model = setup
    loss_fn = make_loss_fn(CFG)
    exact_model = params_from_jax(tree, CFG, device="cpu").double()
    jgrad = _jit_value_and_grad(CFG)
    ours = theirs = 0.0
    for seed in range(4):
        tok = np.random.default_rng(20 + seed).integers(
            0, CFG.vocab, (B, PROMPT + 1)).astype(np.int32)
        tok, lab = tok[:, :-1], tok[:, 1:]
        batch = {"tokens": torch.from_numpy(tok),
                 "labels": torch.from_numpy(lab)}
        _, jg = jgrad(tree, {"tokens": jnp.asarray(tok),
                             "labels": jnp.asarray(lab)})
        want = _flat(jg, CFG).double()
        got = torch.cat([g.reshape(-1) for g in torch.autograd.grad(
            loss_fn(model, batch), list(model.parameters()))]).double()
        with float64():
            grads = torch.autograd.grad(loss_fn(exact_model, batch),
                                        list(exact_model.parameters()))
        assert all(g.dtype == torch.float64 for g in grads)
        exact = torch.cat([g.reshape(-1) for g in grads])
        dist = float((want - exact).norm() / exact.norm())
        assert dist <= 5e-2, (seed, dist)
        ours += float((got - exact).norm() / exact.norm())
        theirs += dist
    assert ours <= 4 * theirs, (ours, theirs)
