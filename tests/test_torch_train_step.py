"""The training step, the optimizers and compression: the port against
``repro`` on the CPU.

Both packages start from ``repro``'s initial parameters
(``params_from_jax``) and see the same seeded numpy batches and
gradients; noise is off (``noise_multiplier=0``), since ``jax.random``
and ``torch.Generator`` draw different numbers.  Tolerances (float32 on
both sides):

* ``_grads_with_loss`` (DP modes ``none``, ``microbatch``, ``example``):
  gradients within 1e-5 of the largest |g|, loss and norms within 1e-5
  relative, ``clip_frac`` equal.  ``recurrentgemma-2b``'s scan is
  sequential in the port and associative in ``repro``;
* two SGD ``train_step``s: the parameters' change within 1e-5 of its
  largest entry, plus one float32 rounding of each parameter;
* AdamW and Adafactor through the optimizer alone on identical numpy
  gradients: 1e-6 of each leaf's largest |value| (Adam's first step is
  about lr * sign(g), so a ulp in a tiny gradient could flip it in a
  whole step);
* int8 compression: bitwise (one IEEE division, round half to even, one
  product a value on both sides), the compressed aggregate too where
  both clip by the same scale (a clip that does not bind, or dyadic
  deltas whose norm is exact in any order).

The Gloo rank function lives here and imports no JAX: ``repro`` is
imported by a fixture, in the parent only.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.launch.sharded_service import spawn
from repro_torch.models import params_from_jax, unflatten
from repro_torch.training import (DPConfig, TrainConfig, adafactor, adamw,
                                  aggregate, compress_tree, compressed_mean,
                                  compressed_psum, decompress_tree,
                                  dequantize_int8, make_loss_fn, make_state,
                                  quantize_int8, sgd, train_step)
from repro_torch.training.train_loop import _grads_with_loss

CFGS = {"flaas": reduced(get_arch("flaas-100m")),
        "rg": reduced(get_arch("recurrentgemma-2b"), n_layers=3)}
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


@pytest.fixture(scope="module")
def J():
    """``repro``'s modules (imported in the parent process only)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import init_model
    from repro.training import compression, fedavg, optimizer, train_loop
    return dataclasses.make_dataclass("J", ["jax", "jnp", "init", "tl",
                                            "opt", "comp", "fedavg"])(
        jax, jnp, init_model, train_loop, optimizer, compression, fedavg)


def _tree(J, cfg, seed=0):
    return J.jax.device_get(J.init(J.jax.random.PRNGKey(seed), cfg,
                                   dtype=J.jnp.float32))


def _batch(seed, cfg, B=4):
    t = np.random.default_rng(seed).integers(0, cfg.vocab, (B, SEQ + 1)
                                              ).astype(np.int32)
    return t[:, :-1], t[:, 1:]


def _jb(J, tok, lab):
    return {"tokens": J.jnp.asarray(tok), "labels": J.jnp.asarray(lab)}


def _tb(tok, lab):
    return {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}


def _flat(J, tree, cfg):
    return params_from_jax(J.jax.device_get(tree), cfg, device="cpu").flat


def _close(got, want, frac):
    got, want = got.detach().double(), want.detach().double()
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= frac * scale, (err, scale)


def _tcfgs(J, mode, clip=0.05, optimizer="adamw", lr=3e-4):
    dp = dict(clip=clip, noise_multiplier=0.0, mode=mode, n_micro=2)
    kw = dict(optimizer=optimizer, lr=lr, param_dtype="float32")
    return (J.tl.TrainConfig(dp=J.tl.DPConfig(**dp), **kw),
            TrainConfig(dp=DPConfig(**dp), **kw))


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("mode", ["none", "microbatch", "example"])
def test_grads_with_loss_match_repro(J, name, mode):
    cfg = CFGS[name]
    tree = _tree(J, cfg)
    model = params_from_jax(tree, cfg, device="cpu")
    tok, lab = _batch(1, cfg)
    jt, tt = _tcfgs(J, mode)
    (jg, jm), jl = J.jax.jit(functools.partial(
        J.tl._grads_with_loss, J.tl.make_loss_fn(cfg), tcfg=jt))(
        tree, _jb(J, tok, lab), J.jax.random.PRNGKey(0))
    (tg, tm), tl = _grads_with_loss(make_loss_fn(cfg), model, _tb(tok, lab),
                                    torch.Generator().manual_seed(0), tt)
    assert list(tg) == [k for k, _ in model.named_parameters()]
    _close(torch.cat([g.reshape(-1) for g in tg.values()]),
           _flat(J, jg, cfg), 1e-5)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert set(tm) == set(jm)
    for k in tm:
        if k == "clip_frac":
            assert float(tm[k]) == float(jm[k]) > 0.0
        else:
            assert abs(float(tm[k]) - float(jm[k])) <= \
                1e-5 * abs(float(jm[k])), k


@pytest.mark.parametrize("name", sorted(CFGS))
def test_two_sgd_train_steps_match_repro(J, name):
    cfg = CFGS[name]
    tree = _tree(J, cfg, seed=1)
    jt, tt = _tcfgs(J, "microbatch", clip=1.0, optimizer="sgd", lr=0.5)
    jstate = J.tl.make_state(J.jax.random.PRNGKey(1), cfg, jt)
    jstate["params"] = tree
    state = make_state(0, cfg, tt, device="cpu")
    state["params"] = params_from_jax(tree, cfg, device="cpu")
    start = state["params"].flat.clone()
    jstep = J.jax.jit(functools.partial(J.tl.train_step, cfg=cfg, tcfg=jt))
    for i in range(2):
        tok, lab = _batch(10 + i, cfg)
        jstate, jm = jstep(jstate, _jb(J, tok, lab))
        state, tm = train_step(state, _tb(tok, lab), cfg, tt)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            1e-5 * abs(float(jm["loss"]))
    assert int(state["step"]) == int(jstate["step"]) == 2
    want = _flat(J, jstate["params"], cfg)
    got = state["params"].flat
    assert float((want - start).abs().max()) > 1e-3      # the steps moved
    bound = 1e-5 * float((want - start).abs().max()) + \
        2.0 ** -23 * want.abs()
    assert bool(torch.all((got - want).abs() <= bound))


def _leaves(seed):
    """Leaves of 1, 2 and 3 dimensions (Adafactor factors the last two)."""
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in {"bias": (5,), "w": (4, 3), "stack": (2, 3, 6)}.items()}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_alone_matches_repro(J, name):
    params, grads = _leaves(2), [_leaves(3 + i) for i in range(3)]
    jo = getattr(J.opt, name)(lr=1e-2)
    to = (adamw if name == "adamw" else adafactor)(lr=1e-2)
    jp, tp = params, {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update(g, js, jp)
        tp, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp)
    for k in params:
        _close(tp[k], torch.tensor(np.asarray(jp[k])), 1e-6)
        _close(ts["master"][k], torch.tensor(np.asarray(js["master"][k])),
               1e-6)
    if name == "adafactor":
        for k, st in ts["stats"].items():
            assert set(st) == set(js["stats"][k])
            for s in st:
                _close(st[s], torch.tensor(np.asarray(js["stats"][k][s])),
                       1e-6)
        assert tuple(ts["stats"]["stack"]["vc"].shape) == (2, 6)
    assert int(ts["count"]) == int(js["count"]) == 3


# ------------------------------------------------ tests/test_training.py's
def _quad_loss(params, batch):
    return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


def _problem(seed, n=64, d=8):
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal((d, 1))
    x = rng.standard_normal((n, d))
    y = x @ w_true + 0.01 * rng.standard_normal((n, 1))
    return ({"x": torch.tensor(x, dtype=torch.float32),
             "y": torch.tensor(y, dtype=torch.float32)},
            {"w": torch.zeros((d, 1))})


def _grad(params, batch):
    w = params["w"].detach().float().requires_grad_()
    return {"w": torch.autograd.grad(_quad_loss({"w": w}, batch), w)[0]}


@pytest.mark.parametrize("make_opt,iters", [(lambda: adamw(lr=5e-2), 60),
                                            (lambda: adafactor(lr=1e-1), 300),
                                            (lambda: sgd(lr=5e-2), 60)])
def test_optimizers_converge(make_opt, iters):
    batch, params = _problem(0)
    opt = make_opt()
    st = opt.init(params)
    loss0 = float(_quad_loss(params, batch))
    for _ in range(iters):
        params, st = opt.update(_grad(params, batch), st, params)
    assert float(_quad_loss(params, batch)) < 0.1 * loss0


@pytest.mark.parametrize("make_opt", [lambda: adamw(lr=5e-2),
                                      lambda: adafactor(lr=1e-1)])
def test_mixed_precision_master(make_opt):
    batch, params = _problem(1)
    params = {k: p.to(torch.bfloat16) for k, p in params.items()}
    opt = make_opt()
    st = opt.init(params)
    assert st["master"]["w"].dtype == torch.float32
    params2, st2 = opt.update(_grad(params, batch), st, params)
    assert params2["w"].dtype == torch.bfloat16
    assert st2["master"]["w"].dtype == torch.float32
    assert torch.equal(params2["w"], st2["master"]["w"].to(torch.bfloat16))


def test_int8_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(256)
                         .astype(np.float32) * 5)
    q, s = quantize_int8(x)
    assert q.dtype == torch.int8
    assert float((dequantize_int8(q, s) - x).abs().max()) <= \
        float(s) * 0.5 + 1e-6


def test_error_feedback_reduces_bias():
    """EF-compressed SGD converges on the quadratic (bias vanishes)."""
    batch, params = _problem(6)
    residual = None
    for _ in range(80):
        (q, s), residual = compress_tree(_grad(params, batch), residual)
        params = {k: p - 5e-2 * g
                  for (k, p), g in zip(params.items(),
                                       decompress_tree(q, s).values())}
    assert float(_quad_loss(params, batch)) < 0.05


def _trees(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": rng.standard_normal(64).astype(np.float32),
             "m": (rng.standard_normal((3, 5)) * 0.01).astype(np.float32)}
            for _ in range(n)]


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def test_compressed_mean_close_to_mean():
    trees = [_t(t) for t in _trees(4)]
    cm = compressed_mean(trees)
    true = sum(t["w"] for t in trees) / 4.0
    assert float((cm["w"] - true).abs().max()) <= 0.05


def test_compression_is_bitwise_repro(J):
    """quantize_int8 (q and scale), compress_tree with error feedback over
    two rounds, decompress_tree and compressed_mean, against repro's."""
    trees = _trees(3, seed=1)
    q, s = quantize_int8(torch.from_numpy(trees[0]["w"]))
    jq, js = J.comp.quantize_int8(trees[0]["w"])
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    res = jres = None
    for t in trees[:2]:
        (tq, ts), res = compress_tree(_t(t), res)
        (jq, js), jres = J.comp.compress_tree(t, jres)
        for k in t:
            assert np.array_equal(tq[k].numpy(), np.asarray(jq[k])), k
            assert np.array_equal(res[k].numpy(), np.asarray(jres[k])), k
        for k, v in decompress_tree(tq, ts).items():
            assert np.array_equal(v.numpy(),
                                  np.asarray(J.comp.decompress_tree(jq,
                                                                    js)[k]))
    got = compressed_mean([_t(t) for t in trees])
    want = J.comp.compressed_mean(trees)
    for k in got:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


def _deltas(model, kind, n, seed):
    """[n, P] deltas: random rows under a clip that never binds, or rows of
    0, +-0.25 and +-0.5 whose norm is exact in any summation order, so a
    binding clip scales them by the same factor in both packages."""
    rng = np.random.default_rng(seed)
    P = model.flat.numel()
    if kind == "random":
        return (rng.standard_normal((n, P)) * rng.uniform(0.01, 0.2, (n, 1))
                ).astype(np.float32)
    return rng.choice(np.float32([-0.5, -0.25, 0.0, 0.25, 0.5]), (n, P))


@pytest.mark.parametrize("kind,clip", [("random", 1e9), ("dyadic", 3.0)])
def test_compressed_aggregate_is_bitwise_repro(J, kind, clip):
    """aggregate(compress=True): per-leaf scales on each clipped row,
    error feedback, the mean -- two rounds, the second with the first's
    residuals -- bitwise repro's, which takes the same clip scales."""
    cfg = CFGS["flaas"]
    model = params_from_jax(_tree(J, cfg), cfg, device="cpu")
    res = jres = None
    for rnd in range(2):
        D = _deltas(model, kind, 4, seed=rnd)
        trees = [{k: v.numpy() for k, v in unflatten(
            model, torch.from_numpy(D[i])).items()} for i in range(4)]
        jmean, jres = J.fedavg.aggregate(trees, clip, 0.0,
                                         J.jax.random.PRNGKey(0),
                                         compress=True, residuals=jres)
        tmean, res = aggregate(torch.from_numpy(D), clip, 0.0, None,
                               compress=True, residuals=res, layout=model)
        want = unflatten(model, torch.zeros_like(tmean))
        for k in want:
            want[k] = torch.tensor(np.asarray(jmean[k]))
        assert torch.equal(tmean, torch.cat([w.reshape(-1)
                                             for w in want.values()]))
        for i in range(4):
            jr = torch.cat([torch.tensor(np.asarray(jres[i][k])).reshape(-1)
                            for k in want])
            assert torch.equal(res[i], jr)
    with pytest.raises(ValueError, match="layout"):
        aggregate(torch.from_numpy(D), clip, 0.0, None, compress=True)


def psum_rank(rank, world, device, n):
    x = torch.from_numpy(np.random.default_rng(rank).standard_normal(n)
                         .astype(np.float32) * (rank + 1))
    return compressed_psum(x).numpy()


def test_compressed_psum_over_two_gloo_ranks():
    """Two ranks under Gloo: every rank gets the same sum, which is the
    int32 sum of each rank's codes against the shared scale (the larger
    peak / 127), dequantized; within world * scale / 2 of the exact
    sum."""
    n = 1000
    got = spawn(psum_rank, 2, backend="gloo", device="cpu", args=(n,),
                timeout=120.0)
    xs = [np.random.default_rng(r).standard_normal(n).astype(np.float32)
          * (r + 1) for r in range(2)]
    assert np.array_equal(got[0], got[1])
    scale = np.float32(max(np.abs(x).max() for x in xs)) / np.float32(127.0)
    codes = sum(np.clip(np.round(x / scale), -127, 127).astype(np.int32)
                for x in xs)
    assert np.array_equal(got[0], codes.astype(np.float32) * scale)
    assert np.abs(got[0] - (xs[0] + xs[1])).max() <= 2 * scale / 2 + 1e-6
