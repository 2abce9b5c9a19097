"""Training the cross-attention configs -- ``llama-3.2-vision-11b``
(``xattn`` blocks reading an image memory) and ``whisper-medium`` (an
encoder over frames, ``encdec`` decoder blocks) -- against ``repro`` on
the CPU: the loss and its gradients, DP gradients with the memory or
frames sliced with their tokens, and the training launcher.

Models: ``configs.reduced`` with ``repro``'s initial float32 parameters
(``params_from_jax``), every norm scale and bias, QKV bias and ``xattn``
gate seeded nonzero on both sides, and a ``0.1 N(0, 1)`` memory / frames
per example from numpy (``test_torch_xattn``'s helpers): at ``repro``'s
init the gates are zero and zero frames encode to zeros, which would hide
the cross path's gradients.  Batches of 4 x 12 tokens.  Tolerances: loss
and DP norms within 1e-5 relative, gradients within 1e-4 of the largest
|g|; the launcher's resumed run bitwise the uninterrupted one.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.launch import train as launcher
from repro_torch.models import params_from_jax
from repro_torch.training import (TrainConfig, dp_gradients, make_loss_fn,
                                  make_state)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.training import dp_sgd as jdp  # noqa: E402
from repro.training import train_loop as jtl  # noqa: E402

from test_torch_xattn import memory_for, perturbed_tree  # noqa: E402

ARCHS_X = ("llama-3.2-vision-11b", "whisper-medium")
BT, SEQ = 4, 12


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


@pytest.fixture(scope="module", params=ARCHS_X)
def setup(request):
    cfg = jreduced(jget_arch(request.param))
    tree = perturbed_tree(cfg, seed=len(request.param))
    return cfg, tree, params_from_jax(tree, cfg, device="cpu")


def _key(cfg):
    return "enc_frames" if cfg.encoder is not None else "memory"


def _batch(cfg, seed):
    """Tokens, labels and a different memory / frames per example."""
    t = np.random.default_rng(seed).integers(0, cfg.vocab, (BT, SEQ + 1)
                                              ).astype(np.int32)
    return {"tokens": t[:, :-1], "labels": t[:, 1:],
            _key(cfg): memory_for(cfg, seed + 50, batch=BT)}


def _flat(tree, cfg):
    return params_from_jax(jax.device_get(tree), cfg, device="cpu").flat


def _close(got, want, frac):
    got, want = got.detach().double(), want.detach().double()
    err = float((got - want).abs().max())
    assert err <= frac * float(want.abs().max()), err


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_loss_and_gradients_match_jax_grad(setup):
    """``make_loss_fn`` with the memory (or frames) in the batch: the loss
    and every gradient, against ``repro``'s ``make_loss_fn`` under
    ``jax.value_and_grad``; the gradient reaches the cross path."""
    cfg, tree, model = setup
    b = _batch(cfg, 1)
    jl, jg = jax.jit(jax.value_and_grad(jtl.make_loss_fn(cfg)))(tree, _jb(b))
    loss = make_loss_fn(cfg)(model, _tb(b))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    _close(torch.cat([g.reshape(-1) for g in grads]), _flat(jg, cfg), 1e-4)
    named = dict(zip([n for n, _ in model.named_parameters()], grads))
    cross = [n for n in named if ".xattn." in n or n.startswith("encoder.")
             or n.endswith(("gate_x", "gate_m"))]
    assert cross and all(named[n].abs().max() > 0 for n in cross)


@pytest.mark.parametrize("mode", ["microbatch", "example"])
def test_dp_gradients_match_repro(setup, mode):
    """``dp_gradients`` without noise, clip 0.05: two microbatches of 2, or
    4 examples each with its own memory as a batch of one (``repro`` vmaps
    ``x[None]``): gradients, norms and loss."""
    cfg, tree, model = setup
    b = _batch(cfg, 2)
    kw = dict(clip=0.05, noise_multiplier=0.0, mode=mode, n_micro=2)
    jg, jm = jax.jit(functools.partial(
        jdp.dp_gradients, jtl.make_loss_fn(cfg), **kw))(
        tree, _jb(b), jax.random.PRNGKey(0))
    tg, tm = dp_gradients(make_loss_fn(cfg), model, _tb(b),
                          torch.Generator().manual_seed(0), **kw)
    _close(torch.cat([g.reshape(-1) for g in tg.values()]), _flat(jg, cfg),
           1e-4)
    assert set(tm) == set(jm)
    for k in tm:
        if k == "clip_frac":
            assert float(tm[k]) == float(jm[k]) > 0.0
        else:
            assert abs(float(tm[k]) - float(jm[k])) <= \
                1e-5 * abs(float(jm[k])), k
    # each example saw its own memory: a batch whose examples share the
    # first one's memory gives other norms
    same = dict(b, **{_key(cfg): np.repeat(b[_key(cfg)][:1], BT, axis=0)})
    _, sm = dp_gradients(make_loss_fn(cfg), model, _tb(same),
                         torch.Generator().manual_seed(0), **kw)
    assert float(sm["grad_norm_max"]) != float(tm["grad_norm_max"])


@pytest.mark.parametrize("name", ARCHS_X)
def test_launcher_trains_and_resumes_bitwise(tmp_path, name):
    """``launch/train.run(arch=..., smoke=True)`` on the CPU with a seeded
    memory (or frames): two steps, and one step then a resume from its
    checkpoint, bitwise; the launcher's zero stub trains to other values,
    and ``make_state`` takes the config."""
    cfg = reduced(get_arch(name))
    make_state(0, cfg, TrainConfig(param_dtype="float32"), device="cpu")
    cross = {_key(cfg): torch.from_numpy(memory_for(cfg, 9, batch=BT))}
    kw = dict(arch=name, smoke=True, device="cpu", batch=BT, seq=SEQ,
              ckpt_every=1, log=None, **cross)
    full = launcher.run(steps=2, ckpt=str(tmp_path / "a"), **kw)
    first = launcher.run(steps=1, ckpt=str(tmp_path / "b"), **kw)
    rest = launcher.run(steps=1, ckpt=str(tmp_path / "b"), **kw)
    assert rest["resumed_from"] == 1 and full["checkpoints"] == [1, 2]
    strip = [{k: v for k, v in r.items() if k != "wall_s"}
             for r in first["records"] + rest["records"]]
    assert strip == [{k: v for k, v in r.items() if k != "wall_s"}
                     for r in full["records"]]
    assert all(np.isfinite(r["loss"]) for r in full["records"])
    a, b = full["state"], rest["state"]
    assert torch.equal(a["params"].flat, b["params"].flat)
    for part in ("m", "v", "master"):
        for k, t in a["opt"][part].items():
            assert torch.equal(t, b["opt"][part][k]), (part, k)
    # at init llama's gates are zero, so the memory moves the first step's
    # gradients (the gates'), not its loss: the step ends elsewhere
    zero = launcher.run(steps=1, ckpt=str(tmp_path / "c"),
                        **dict(kw, **{_key(cfg): None}))
    assert not torch.equal(zero["state"]["params"].flat,
                           first["state"]["params"].flat)
