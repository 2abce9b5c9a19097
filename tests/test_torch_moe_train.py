"""Training the MoE family against ``repro`` on the CPU: DP gradients
(modes ``none``, ``microbatch``, ``example``) and one ``train_step``
with the launcher's optimizer (AdamW for ``mixtral-8x22b``, Adafactor for
``kimi-k2-1t-a32b``), on ``test_torch_moe_models``' reduced models.
Each path routes the tokens of its own call, as ``repro`` does: DP's
microbatch B/2*S tokens, an example S.  Tolerances: loss and DP norms
within 1e-5 relative, gradients within 1e-4 of the largest |g|; the
train step's in ``test_train_step_matches_repro``.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.launch import train as launcher
from repro_torch.models import params_from_jax, unflatten
from repro_torch.training import (DPConfig, TrainConfig, make_loss_fn,
                                  make_state, train_step)
from repro_torch.training.train_loop import _grads_with_loss

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.training import train_loop as jtl  # noqa: E402

from test_torch_moe_models import (_batch, _close, _flat, _jb,  # noqa: E402
                                   _tb, setup)

__all__ = ["setup"]           # the reduced models, one per config


_REPRO_GRADS = {}


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


def _repro_grads(cfg, tree, mode):
    """``repro``'s ``_grads_with_loss`` on ``_batch(cfg, 1)``, clip 0.05, no
    noise, two microbatches: ``((grads, metrics), loss)``, computed once
    per config and mode (the DP tests and the train step share it)."""
    key = (cfg.name, mode)
    if key not in _REPRO_GRADS:
        jt = jtl.TrainConfig(dp=jtl.DPConfig(**_dp(mode)),
                             param_dtype="float32")
        tok, lab = _batch(cfg, 1)
        _REPRO_GRADS[key] = jax.jit(functools.partial(
            jtl._grads_with_loss, jtl.make_loss_fn(cfg), tcfg=jt))(
            tree, _jb(tok, lab), jax.random.PRNGKey(0))
    return _REPRO_GRADS[key]


def _dp(mode):
    return dict(clip=0.05, noise_multiplier=0.0, mode=mode, n_micro=2)


@pytest.mark.parametrize("mode", ["none", "microbatch", "example"])
def test_grads_with_loss_match_repro(setup, mode):
    """DP mode ``none`` (the loss's gradients), ``microbatch`` (2 slices
    of 2 examples) and ``example`` (4 examples of 12 tokens, each routed
    alone), clip 0.05, no noise: gradients, loss and norms."""
    cfg, tree, model = setup
    tok, lab = _batch(cfg, 1)
    tt = TrainConfig(dp=DPConfig(**_dp(mode)), param_dtype="float32")
    (jg, jm), jl = _repro_grads(cfg, tree, mode)
    (tg, tm), tl = _grads_with_loss(make_loss_fn(cfg), model, _tb(tok, lab),
                                    torch.Generator().manual_seed(0), tt)
    _close(torch.cat([g.reshape(-1) for g in tg.values()]),
           _flat(jg, cfg), 1e-4)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert set(tm) == set(jm)
    for k in tm:
        if k == "clip_frac":
            assert float(tm[k]) == float(jm[k])
        else:
            assert abs(float(tm[k]) - float(jm[k])) <= \
                1e-5 * abs(float(jm[k])), k
    model.zero_grad(set_to_none=True)


def test_train_step_matches_repro(setup):
    """One ``train_step`` with the launcher's optimizer (AdamW; kimi's
    Adafactor), two microbatches, clip 0.05, no noise, from the same
    parameters: the port's gradients within 1e-4 of each leaf's largest
    |g| of ``repro``'s, then the parameters.

    AdamW: against ``repro``'s ``train_step``, within four float32
    roundings (of the parameter and of its lr-sized step) plus what the
    gradients' tolerance d (1e-4 of the leaf's largest |g|) can move
    Adam's first step lr * g / (|g| + eps) by: lr * eps * d / (|g| -
    d)^2, at most 2 lr (a sign flip where |g| <= d).

    Adafactor: ``repro`` updates its scanned body as stacked [n_groups,
    ...] leaves, so a stacked 1-D leaf (a norm scale) gets statistics
    factored across the layers and every stacked leaf's RMS clip is taken
    over all of them; the port updates each layer's parameter alone.  So
    the port's step is held to ``repro``'s Adafactor applied layer by
    layer to the port's gradients (four roundings of the parameter and
    1e-5 of its step: the statistics are means over a matrix's rows and
    columns, summed in another order), and the stacked difference on the
    body's norm scales is pinned."""
    cfg, tree, model = setup
    opt = "adafactor" if cfg.name.startswith("kimi") else "adamw"
    assert launcher.train_config(cfg, 4, 0.0, 1.0).optimizer == opt
    dp = _dp("microbatch")
    jt = jtl.TrainConfig(optimizer=opt, dp=jtl.DPConfig(**dp),
                         param_dtype="float32")
    tt = TrainConfig(optimizer=opt, dp=DPConfig(**dp), param_dtype="float32")
    tok, lab = _batch(cfg, 1)
    (jg, _), _ = _repro_grads(cfg, tree, "microbatch")
    (tg, _), _ = _grads_with_loss(make_loss_fn(cfg), model, _tb(tok, lab),
                                  torch.Generator().manual_seed(0), tt)
    model.zero_grad(set_to_none=True)
    sizes = [(n, p.numel()) for n, p in model.named_parameters()]
    jflat = _flat(jg, cfg)
    tflat = torch.cat([tg[n].reshape(-1) for n, _ in sizes])
    d, off = torch.empty_like(jflat), 0          # the leaves' tolerances
    for _, k in sizes:
        d[off:off + k] = 1e-4 * float(jflat[off:off + k].abs().max())
        off += k
    assert bool(((tflat - jflat).abs() <= d).all())

    jstate = jtl.make_state(jax.random.PRNGKey(1), cfg, jt)
    jstate["params"] = tree
    jstate["opt"] = jt.make_optimizer().init(tree)
    jstate, jm = jax.jit(functools.partial(jtl.train_step, cfg=cfg,
                                           tcfg=jt))(jstate, _jb(tok, lab))
    state = make_state(0, cfg, tt, device="cpu")
    state["params"] = params_from_jax(tree, cfg, device="cpu")
    state["opt"] = tt.make_optimizer().init(state["params"])
    start = state["params"].flat.clone()
    state, tm = train_step(state, _tb(tok, lab), cfg, tt)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        1e-5 * abs(float(jm["loss"]))
    want, got = _flat(jstate["params"], cfg), state["params"].flat
    assert float((want - start).abs().max()) > 0.5 * tt.lr  # it moved
    slack = 4 * 2.0 ** -24 * (want.abs() + tt.lr)   # roundings of p, step
    if opt == "adamw":
        near = torch.clamp(jflat.abs() - d, min=0.0)
        adam = tt.lr * torch.clamp(1e-8 * d / torch.clamp(near ** 2,
                                                          min=1e-38), max=2.0)
        assert bool(((got - want).abs() <= slack + adam).all())
        return
    per_leaf = {n: jnp.asarray(t.numpy())
                for n, t in unflatten(model, start).items()}
    grads = {n: jnp.asarray(g.numpy()) for n, g in tg.items()}
    o = jt.make_optimizer()
    layered, _ = jax.jit(o.update)(grads, o.init(per_leaf), per_leaf)
    layered = torch.cat([torch.from_numpy(np.array(layered[n])).reshape(-1)
                         for n, _ in sizes])
    # a step's own rounding: its statistics are means over a matrix's rows
    # and columns, summed in another order on each side
    step = 4 * 2.0 ** -24 * layered.abs() + 1e-5 * (layered - start).abs()
    assert bool(((got - layered).abs() <= step).all())
    off = 0
    for n, k in sizes:
        layer = int(n.split(".")[1]) if n.startswith("blocks.") else -1
        if layer >= len(cfg.prefix) and n.endswith("norm1.scale"):
            # the stacked factoring, pinned: the norm scale's step moves
            seg = slice(off, off + k)
            assert float((want - got)[seg].abs().max()) > \
                1e-2 * float((want - start)[seg].abs().max())
        off += k


