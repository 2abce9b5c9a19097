"""Training: gradients, optimizers, DP-SGD and one DP-FedAvg round, the
port against ``repro`` on the CPU.

Both packages start from ``repro``'s initial parameters
(``params_from_jax``) and see the same seeded numpy batches.  Tolerances
(float32 on both sides; autodiff through attention, norms and the
softmax rounds differently in XLA and PyTorch):

* gradients, DP-SGD means and optimizer steps: 1e-5 of the largest entry
  (gaps measured ~1e-7 of it);
* one client update, as a delta: 1e-5 of its largest entry; one FedAvg
  round, as parameters: that, plus one float32 rounding of ``p + delta``;
* discrete outputs -- cohort, kept set (clients and their order),
  straggler count -- equal.

Noise is never compared draw by draw (``jax.random`` and
``torch.Generator`` differ): its distribution and reproducibility are
tested on their own.
"""
import dataclasses

import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced
from repro_torch.configs import get_arch
from repro_torch.models import params_from_jax, unflatten
from repro_torch.privacy import RdpAccountant
from repro_torch.training import (FedAvgConfig, TrainConfig, adamw,
                                  add_noise, aggregate, client_update,
                                  dp_gradients, fl_round, make_loss_fn,
                                  make_state, sgd)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.training import fedavg as jfedavg  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.dp_sgd import dp_gradients as jdp_gradients  # noqa: E402
from repro.training.train_loop import make_loss_fn as jmake_loss  # noqa: E402

CFG = reduced(get_arch("flaas-100m"))
GQA = dataclasses.replace(CFG, kv_heads=2, window=4,
                          pattern=(("swa", False), ("attn", False)),
                          n_layers=3)
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


def _tree(cfg, seed=0):
    return jax.device_get(jinit(jax.random.PRNGKey(seed), cfg,
                                dtype=jnp.float32))


def _batch(seed, B=2, vocab=CFG.vocab):
    t = np.random.default_rng(seed).integers(0, vocab, (B, SEQ + 1)
                                              ).astype(np.int32)
    return t[:, :-1], t[:, 1:]


def _jb(tok, lab):
    return {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}


def _tb(tok, lab):
    return {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}


def _flat(tree, cfg):
    """``repro`` tree (params, grads or deltas) -> the port's flat layout."""
    return params_from_jax(jax.device_get(tree), cfg, device="cpu").flat


def _close(got, want, frac=1e-5):
    got, want = got.detach().double(), want.detach().double()
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= frac * scale, (err, scale)


@pytest.mark.parametrize("cfg", [CFG, GQA], ids=["flaas-smoke", "gqa"])
def test_gradients_match_jax_grad(cfg):
    tree = _tree(cfg)
    model = params_from_jax(tree, cfg, device="cpu")
    tok, lab = _batch(1, B=3)
    jl, jg = jax.jit(jax.value_and_grad(jmake_loss(cfg)))(tree,
                                                           _jb(tok, lab))
    loss = make_loss_fn(cfg)(model, _tb(tok, lab))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    _close(torch.cat([g.reshape(-1) for g in grads]), _flat(jg, cfg))


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_optimizer_steps_match_repro(name):
    rng = np.random.default_rng(2)
    shapes = {"a": (4, 3), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    jo = jopt.sgd(0.1) if name == "sgd" else jopt.adamw(1e-2)
    to = sgd(0.1) if name == "sgd" else adamw(1e-2)
    jp, tp = params, {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update(g, js, jp)
        tp, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp)
    for k in shapes:
        _close(tp[k], torch.tensor(np.asarray(jp[k])))
    assert int(ts["count"]) == int(js["count"]) == 3


@functools.lru_cache(maxsize=None)
def _jit_dp_gradients(mode, n_micro):
    """``repro``'s ``dp_gradients`` jitted once per mode, the clip an
    argument (one compile for both clips)."""
    def fn(tree, batch, key, clip):
        return jdp_gradients(jmake_loss(CFG), tree, batch, key, clip=clip,
                             mode=mode, n_micro=n_micro)
    return jax.jit(fn)


@pytest.mark.parametrize("mode,n_micro", [("example", 1), ("microbatch", 2)])
@pytest.mark.parametrize("clip", [0.05, 100.0])
def test_dp_gradients_match_repro(mode, n_micro, clip):
    tree = _tree(CFG)
    model = params_from_jax(tree, CFG, device="cpu")
    tok, lab = _batch(3, B=4)
    jg, jm = _jit_dp_gradients(mode, n_micro)(
        tree, _jb(tok, lab), jax.random.PRNGKey(0), clip)
    gen = torch.Generator().manual_seed(0)
    tg, tm = dp_gradients(make_loss_fn(CFG), model, _tb(tok, lab), gen,
                          clip=clip, mode=mode, n_micro=n_micro)
    _close(torch.cat([g.reshape(-1) for g in tg.values()]), _flat(jg, CFG))
    for k in ("grad_norm_mean", "grad_norm_max", "loss_mean"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k]))
    assert float(tm["clip_frac"]) == float(jm["clip_frac"])


def test_client_update_matches_repro():
    tree = _tree(CFG)
    model = params_from_jax(tree, CFG, device="cpu")
    before = model.flat.clone()
    batches = [_batch(s) for s in (4, 5)]
    jd = jfedavg.client_update(tree, jmake_loss(CFG),
                               [_jb(*b) for b in batches], 0.05, 2)
    td = client_update(model, make_loss_fn(CFG), [_tb(*b) for b in batches],
                       0.05, 2)
    assert torch.equal(model.flat, before)              # params untouched
    _close(td, _flat(jd, CFG))


def test_aggregate_matches_repro_without_noise():
    model = params_from_jax(_tree(CFG), CFG, device="cpu")
    rng = np.random.default_rng(6)
    P = model.flat.numel()
    D = (rng.standard_normal((5, P)) * rng.uniform(0.01, 0.2, (5, 1))
         ).astype(np.float32)
    trees = [{k: v.numpy() for k, v in unflatten(model, torch.from_numpy(
        D[i])).items()} for i in range(5)]
    jmean, _ = jfedavg.aggregate(trees, 0.05, 0.0, jax.random.PRNGKey(0))
    tmean, _ = aggregate(torch.from_numpy(D), 0.05, 0.0,
                         torch.Generator().manual_seed(0))
    want = torch.cat([torch.tensor(np.asarray(jmean[k])).reshape(-1)
                      for k in unflatten(model, tmean)])
    _close(tmean, want)
    # compressed: the same clip, then int8 on each leaf of each row
    # (repro's per-tree-leaf scale).  The clip scales differ by ulps, so a
    # value on a rounding boundary may take the next code: within one
    # quantum (the leaf's largest clipped |value| / 127) of repro's mean
    jmean, _ = jfedavg.aggregate(trees, 0.05, 0.0, jax.random.PRNGKey(0),
                                 compress=True)
    tmean, res = aggregate(torch.from_numpy(D), 0.05, 0.0, None,
                           compress=True, layout=model)
    scales = np.minimum(1.0, 0.05 / np.linalg.norm(D, axis=1))
    clipped = unflatten(model, torch.from_numpy(
        np.abs(D * scales[:, None]).max(axis=0).astype(np.float32)))
    for k, v in unflatten(model, tmean).items():
        quantum = float(clipped[k].max()) / 127.0
        w = torch.tensor(np.asarray(jmean[k]))
        assert float((v - w).abs().max()) <= quantum * (1 + 1e-5), k
    assert tuple(res.shape) == D.shape


def _fl_setup(n_dev):
    data = {d: _batch(100 + d) for d in range(n_dev)}
    jdata = {d: (lambda d=d: [_jb(*data[d])]) for d in data}
    tdata = {d: (lambda d=d: [_tb(*data[d])]) for d in data}
    return jdata, tdata


def _repro_kept(monkeypatch, jdata):
    """Wrap ``repro``'s loaders and ``ClientResult`` so its round reports
    which device each result came from; returns the record list."""
    seen, current = [], {}

    def loader(d, f):
        def load():
            current["dev"] = d
            return f()
        return load

    class Recorded(jfedavg.ClientResult):
        def __init__(self, delta, n, lat):
            super().__init__(delta, n, lat)
            seen.append((lat, current["dev"]))

    monkeypatch.setattr(jfedavg, "ClientResult", Recorded)
    return {d: loader(d, f) for d, f in jdata.items()}, seen


@pytest.mark.parametrize("n_dev,round_idx", [(8, 0), (8, 3), (4, 1)])
def test_fl_round_matches_repro_without_noise(monkeypatch, n_dev, round_idx):
    tree = _tree(CFG)
    model = params_from_jax(tree, CFG, device="cpu")
    start = model.flat.clone()
    jdata, tdata = _fl_setup(n_dev)
    jdata, seen = _repro_kept(monkeypatch, jdata)
    cfg = FedAvgConfig(cohort_size=5, over_select=1.25, deadline_frac=0.8,
                       local_lr=0.02, clip=0.05, seed=round_idx)
    jnew, jm = jfedavg.fl_round(tree, jmake_loss(CFG), jdata,
                                list(range(n_dev)), cfg, sigma=0.0,
                                round_idx=round_idx)
    tnew, tm = fl_round(model, make_loss_fn(CFG), tdata, list(range(n_dev)),
                        cfg, sigma=0.0, round_idx=round_idx)
    assert tnew is model                                 # updated in place
    for k in ("cohort", "stragglers_dropped", "selected"):
        assert tm[k] == jm[k], k
    kept = [d for _, d in sorted(seen)][:jm["cohort"]]
    assert tm["kept"] == kept
    # new parameters: the delta's tolerance plus the one rounding of p + d
    want = _flat(jnew, CFG)
    bound = 1e-5 * float((want - start).abs().max()) + 2.0 ** -23 * want.abs()
    assert bool(torch.all((tnew.flat - want).abs() <= bound))


def test_fl_round_records_the_grant_and_noise_is_calibrated():
    model = params_from_jax(_tree(CFG), CFG, device="cpu")
    _, tdata = _fl_setup(8)
    acc = RdpAccountant(alpha_star=8.0)
    cfg = FedAvgConfig(cohort_size=5, clip=0.05, seed=1)
    fl_round(model, make_loss_fn(CFG), tdata, list(range(8)), cfg,
             accountant=acc, sigma=2.0, round_idx=0)
    assert acc.spent_at_alpha_star == acc.step_cost(2.0)


@pytest.mark.parametrize("n,sigma,clip", [(6, 6.3, 0.05), (1, 1.0, 1.0)])
def test_aggregate_noise_std_and_reproducibility(n, sigma, clip):
    """Zero deltas leave only the noise: its std is sigma * clip / n within
    1% over 2e6 draws, its mean ~0, and the same seed gives the same
    draws (a different seed does not)."""
    D = torch.zeros((n, 2_000_000))

    def noise(seed):
        return aggregate(D, clip, sigma * clip,
                         torch.Generator().manual_seed(seed))[0]
    a = noise(7)
    want = sigma * clip / n
    assert abs(float(a.std()) / want - 1.0) < 0.01
    assert abs(float(a.mean())) < 5 * want / np.sqrt(a.numel())
    assert torch.equal(a, noise(7)) and not torch.equal(a, noise(8))
    tree = add_noise({"x": torch.zeros(1000)},
                     torch.Generator().manual_seed(0), 0.5)
    assert tree["x"].std() > 0.4


def test_make_state_is_float32_only():
    """The float32 state as before; since bfloat16 parameters came to the
    port, ``TrainConfig()``'s default (``repro``'s bfloat16) builds a
    bfloat16 model with a float32 master, and any other dtype raises."""
    st = make_state(0, CFG, TrainConfig(), device="cpu")
    assert st["params"].dtype == torch.bfloat16
    assert st["opt"]["master"]["embed.table"].dtype == torch.float32
    with pytest.raises(ValueError):
        make_state(0, CFG, TrainConfig(param_dtype="float16"), device="cpu")
    st = make_state(0, CFG, TrainConfig(param_dtype="float32"), device="cpu")
    assert st["params"].flat.dtype == torch.float32
    assert set(st["opt"]) == {"m", "v", "count", "master"}
    st = make_state(0, CFG, TrainConfig(optimizer="adafactor",
                                        param_dtype="float32"), device="cpu")
    assert set(st["opt"]) == {"stats", "count", "master"}

