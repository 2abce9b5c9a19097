"""bfloat16 training against ``repro`` in bfloat16 on the CPU: one
``train_step`` (AdamW and Adafactor, with and without the float32 master;
DP modes none, microbatch and example), ``fl_round``, and the bfloat16
checkpoint and launcher round trips.

Models and parameters: :mod:`test_torch_bf16`'s (the reduced config,
``repro``'s bfloat16 ``init_model`` with norms, QKV biases and gates
seeded nonzero, carried across bitwise); the steps on ``qwen2.5-3b`` and
``mixtral-8x22b``; batches of B = 4 x 8 seeded tokens; noise off
(``jax.random`` and ``torch.Generator`` draw different numbers).  The
other families' bfloat16 forward is held in :mod:`test_torch_bf16`, and
a step of each costs ~15 s here (two XLA compiles); ``qwen2.5-3b`` and
``recurrentgemma-2b`` also train in bfloat16 on the card against the CPU
(``chip_smoke.py`` phase 34).  ``repro``'s Adafactor factors a stacked
body leaf across the layers (ROADMAP Queue 3), so its steps are held to
``repro``'s gradients with ``repro``'s optimizer applied to the port's
per-layer leaves.

Bounds, measured from ``repro`` itself: d, the distance between
``repro``'s bfloat16 step and its float32 step on the same
bfloat16-valued parameters (the loss; each DP metric).  Each test asserts
the loss's d is under 5e-2 of the loss, so the bound cannot go vacuous,
and holds the port to 2 d of ``repro``'s bfloat16 step (each run about d
from the exact value) plus half a bfloat16 ulp of the value: the port
rounds every operation's output to bfloat16, XLA:CPU keeps some fused
intermediates in float32 (its excess precision), so ``repro``'s
bfloat16 step sits nearer its float32 one than a run that rounds each
operation (qwen2.5-3b's microbatch gradient norm: the port 0.14% from
``repro``'s, against a d of 0.03%; whisper-medium's loss 3.5 d).  After
one AdamW step the float32 masters lie within 2 lr of each other (Adam's
first step is lr * g / |g| a leaf element: a gradient sign that the two
roundings see differently moves it by at most 2 lr), and without a
master the new bfloat16 parameters within that plus one bfloat16 ulp;
after one Adafactor step within two of ``repro``'s largest steps in the
leaf (its update is clipped by its RMS, not elementwise).
``fl_round``: cohort and kept set equal, the new bfloat16 parameters
within 2 d of ``repro``'s (d: ``repro``'s bfloat16 round against its
float32 round) plus one bfloat16 ulp.  Checkpoints and the launcher's
resume: bitwise.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import train as launcher
from repro_torch.models import params_from_jax
from repro_torch.training import (DPConfig, FedAvgConfig, TrainConfig,
                                  fl_round, make_loss_fn, make_state,
                                  train_step)

from test_torch_bf16 import (as_f32, bf16_bits, bf16_tree, cfg_of,
                             jcfg_of)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.training import fedavg as jfedavg  # noqa: E402
from repro.training import train_loop as jtl  # noqa: E402

VACUOUS = 5e-2
FACTOR = 2.0
HALF_ULP = 2.0 ** -9    # half a bfloat16 ulp, relative (the largest)
LR = 1e-3
B, SEQ = 4, 8
# (family, optimizer, DP mode, keep_master): every DP mode, both
# optimizers, with the master and without it (the master-less path is
# one line shared by both optimizers, ``st.get("master",
# _master(params))``)
CASES = [("qwen2.5-3b", "adamw", "example", True),
         ("qwen2.5-3b", "adafactor", "microbatch", False),
         ("mixtral-8x22b", "adamw", "none", True)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's side: its CPU work here is small,
    and the test runner runs several workers at once, each of whose
    thread pools would otherwise oversubscribe the cores (the float32
    launcher-resume test takes ~1 s alone and ~45 s so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
                   - 7)


def batch(cfg, seed, n=B):
    """(repro's bfloat16 batch, its float32 copy, the port's batch)."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab, (n, SEQ + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(t[:, :-1]), "labels": jnp.asarray(t[:, 1:])}
    tb = {"tokens": torch.from_numpy(t[:, :-1]),
          "labels": torch.from_numpy(t[:, 1:])}
    jb32 = dict(jb)
    if cfg.cross_memory_len:
        name = "enc_frames" if cfg.encoder is not None else "memory"
        x = jnp.asarray(0.1 * rng.standard_normal(
            (n, cfg.cross_memory_len, cfg.d_model)), jnp.bfloat16)
        jb[name], jb32[name] = x, jnp.asarray(x, jnp.float32)
        tb[name] = torch.from_numpy(np.asarray(x, np.float32)).to(
            torch.bfloat16)
    return jb, jb32, tb


def tcfgs(opt, mode, keep_master, dtype):
    dp = dict(clip=0.05, noise_multiplier=0.0, mode=mode, n_micro=2)
    kw = dict(optimizer=opt, lr=LR, param_dtype=dtype,
              keep_master=keep_master)
    return (jtl.TrainConfig(dp=jtl.DPConfig(**dp), **kw),
            TrainConfig(dp=DPConfig(**dp), **kw))


def repro_step(tree, jcfg, jt, jbatch):
    state = {"params": tree, "opt": jt.make_optimizer().init(tree),
             "step": jnp.zeros((), jnp.int32),
             "rng": jax.random.PRNGKey(0)}
    step = jax.jit(functools.partial(jtl.train_step, cfg=jcfg, tcfg=jt))
    new, m = step(state, jbatch)
    return jax.device_get(new), {k: float(v) for k, v in m.items()}


def repro_layerwise(tree, jcfg, cfg, jt, jbatch):
    """``repro``'s gradients and metrics, then its optimizer applied to
    the port's leaves, one layer's leaf at a time: ``repro``'s Adafactor
    factors a stacked body leaf [n_groups, ...] across the layers
    (ROADMAP Queue 3), the port each layer's own.  Returns ({"params",
    "opt": {"master"}} in the port's names, metrics)."""
    (g, m), loss = jax.jit(functools.partial(
        jtl._grads_with_loss, jtl.make_loss_fn(jcfg), tcfg=jt))(
        tree, jbatch, jax.random.PRNGKey(0))
    names = port_leaves(tree, cfg)
    grads = {k: jnp.asarray(v, jnp.float32)
             for k, v in port_leaves(jax.device_get(g), cfg).items()}
    model = params_from_jax(tree, cfg, device="cpu", dtype=torch.bfloat16)
    params = {k: jnp.asarray(p.detach().float().numpy(),
                             jnp.bfloat16 if p.dtype == torch.bfloat16
                             else jnp.float32)
              for k, p in model.named_parameters()}
    assert set(params) == set(names)
    opt = jt.make_optimizer()
    new, st = jax.jit(opt.update)(grads, opt.init(params), params)
    out = {"params": {k: np.asarray(v, np.float64) for k, v in new.items()}}
    if "master" in st:
        out["opt"] = {"master": {k: np.asarray(v, np.float64)
                                 for k, v in st["master"].items()}}
    return out, {"loss": float(loss), **{k: float(v) for k, v in m.items()}}


def port_leaves(tree_or_model, cfg):
    """{name: float64 numpy} in the port's parameter names."""
    if isinstance(tree_or_model, dict):
        tree_or_model = params_from_jax(tree_or_model, cfg, device="cpu")
    return {k: p.detach().double().numpy()
            for k, p in tree_or_model.named_parameters()}


@pytest.mark.parametrize("name,opt,mode,keep_master", CASES)
def test_bf16_train_step_matches_repro(name, opt, mode, keep_master):
    jcfg, cfg = jcfg_of(name), cfg_of(name)
    tree = bf16_tree(name)
    jb, jb32, tb = batch(cfg, len(name))
    jt, tt = tcfgs(opt, mode, keep_master, "bfloat16")
    jt32, _ = tcfgs(opt, mode, keep_master, "float32")
    if opt == "adafactor":
        jnew, jm = repro_layerwise(tree, jcfg, cfg, jt, jb)
        _, jm32 = repro_layerwise(as_f32(tree), jcfg, cfg, jt32, jb32)
    else:
        jnew, jm = repro_step(tree, jcfg, jt, jb)
        _, jm32 = repro_step(as_f32(tree), jcfg, jt32, jb32)

    state = make_state(0, cfg, tt, device="cpu")
    state["params"] = params_from_jax(tree, cfg, device="cpu",
                                      dtype=torch.bfloat16)
    state["opt"] = tt.make_optimizer().init(state["params"])
    before = port_leaves(state["params"], cfg)
    state, tm = train_step(state, tb, cfg, tt)
    assert state["params"].dtype == torch.bfloat16
    assert set(tm) == set(jm)
    d_loss = abs(jm["loss"] - jm32["loss"])
    assert 0 < d_loss < VACUOUS * abs(jm32["loss"]), (d_loss, jm32["loss"])
    for k in tm:
        got = float(tm[k])
        if k == "clip_frac":
            assert got == jm[k]
            continue
        assert abs(got - jm[k]) <= FACTOR * abs(jm[k] - jm32[k]) + \
            HALF_ULP * abs(jm[k]), (k, got, jm[k], jm32[k])

    leaves = (lambda t: t) if opt == "adafactor" else \
        (lambda t: port_leaves(t, cfg))
    got = port_leaves(state["params"], cfg)
    want = leaves(jnew["params"])
    if keep_master:
        got_m = {k: v.double().numpy() for k, v in
                 state["opt"]["master"].items()}
        want_m = leaves(jnew["opt"]["master"])
        for k, p in state["params"].named_parameters():
            master = state["opt"]["master"][k]   # rounded once into p
            assert master.dtype == torch.float32
            assert torch.equal(p, master.to(p.dtype)), k
    else:
        got_m, want_m = got, want
    for k in got_m:
        if opt == "adamw":
            bound = FACTOR * LR + (0 if keep_master else bf16_ulp(want_m[k]))
        else:
            step = np.abs(want_m[k] - before[k]).max()
            bound = FACTOR * step + (0 if keep_master else
                                     bf16_ulp(want_m[k]))
        assert np.all(np.abs(got_m[k] - want_m[k]) <= bound + 1e-7), k


def test_bf16_fl_round_matches_repro(monkeypatch):
    from test_torch_training import _repro_kept
    name = "qwen2.5-3b"
    jcfg, cfg = jcfg_of(name), cfg_of(name)
    tree = bf16_tree(name)
    n_dev = 6
    data = {d: batch(cfg, 200 + d, n=2) for d in range(n_dev)}
    fcfg = FedAvgConfig(cohort_size=4, over_select=1.25, deadline_frac=0.8,
                        local_lr=0.05, clip=0.05, seed=1)

    def repro_round(tr, which):
        jdata = {d: (lambda d=d: [data[d][which]]) for d in data}
        jdata, seen = _repro_kept(monkeypatch, jdata)
        new, m = jfedavg.fl_round(tr, jtl.make_loss_fn(jcfg), jdata,
                                  list(range(n_dev)), fcfg, sigma=0.0,
                                  round_idx=1)
        return port_leaves(jax.device_get(new), cfg), m, seen
    jnew32, _, _ = repro_round(as_f32(tree), 1)
    jnew, jm, seen = repro_round(tree, 0)      # its records: this round's
    model = params_from_jax(tree, cfg, device="cpu", dtype=torch.bfloat16)
    tdata = {d: (lambda d=d: [data[d][2]]) for d in data}
    tnew, tm = fl_round(model, make_loss_fn(cfg), tdata, list(range(n_dev)),
                        fcfg, sigma=0.0, round_idx=1)
    assert tnew is model and model.dtype == torch.bfloat16
    for k in ("cohort", "stragglers_dropped", "selected"):
        assert tm[k] == jm[k], k
    assert tm["kept"] == [d for _, d in sorted(seen)][:jm["cohort"]]
    got = port_leaves(model, cfg)
    start = port_leaves(tree, cfg)
    moved = max(np.abs(jnew[k] - start[k]).max() for k in jnew)
    assert moved > 0                                  # the round moved
    for k in got:
        d = np.abs(jnew[k] - jnew32[k]).max()
        bound = FACTOR * d + bf16_ulp(jnew[k])
        assert np.all(np.abs(got[k] - jnew[k]) <= bound), k


def _bf16_state(cfg, keep_master=True):
    tt = TrainConfig(optimizer="adamw", lr=LR, param_dtype="bfloat16",
                     keep_master=keep_master,
                     dp=DPConfig(clip=1.0, noise_multiplier=0.1, n_micro=2))
    return tt, make_state(0, cfg, tt, device="cpu")


def test_bf16_checkpoint_round_trip_is_bitwise(tmp_path):
    cfg = cfg_of("recurrentgemma-2b")
    tt, state = _bf16_state(cfg)
    tb = batch(cfg, 7)[2]
    state, _ = train_step(state, tb, cfg, tt)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    with np.load(tmp_path / "step_0000000001" / "state.npz") as z:
        listed = set(z["__bfloat16__"].tolist())
        stored = {k: z[k].dtype for k in z.files}
    names = {f"d:params|d:{k}" for k, p in state["params"].named_parameters()
             if p.dtype == torch.bfloat16}
    assert listed == names and all(stored[k] == np.uint16 for k in names)
    back, at = mgr.restore(_bf16_state(cfg)[1])
    assert at == 1 and back["params"].dtype == torch.bfloat16
    for (k, p), q in zip(state["params"].named_parameters(),
                         back["params"].parameters()):
        assert p.dtype == q.dtype, k
        if p.dtype == torch.bfloat16:
            assert np.array_equal(bf16_bits(p), bf16_bits(q)), k
        else:
            assert torch.equal(p, q), k
    for part in ("m", "v", "master"):
        for k, t in state["opt"][part].items():
            assert torch.equal(t, back["opt"][part][k]), (part, k)


def test_bf16_launcher_resume_is_bitwise(tmp_path):
    kw = dict(smoke=True, device="cpu", ckpt_every=2, log=None,
              param_dtype="bfloat16")
    full = launcher.run(steps=4, ckpt=str(tmp_path / "a"), **kw)
    launcher.run(steps=2, ckpt=str(tmp_path / "b"), **kw)
    rest = launcher.run(steps=2, ckpt=str(tmp_path / "b"), **kw)
    assert rest["resumed_from"] == 2 and full["tcfg"].keep_master
    a, b = full["state"], rest["state"]
    assert a["params"].dtype == b["params"].dtype == torch.bfloat16
    for dt, buf in a["params"].flats.items():
        assert torch.equal(buf.view(torch.int16) if dt == torch.bfloat16
                           else buf, b["params"].flats[dt].view(
                               torch.int16) if dt == torch.bfloat16
                           else b["params"].flats[dt]), dt
    for part in ("m", "v", "master"):
        for k, t in a["opt"][part].items():
            assert torch.equal(t, b["opt"][part][k]), (part, k)
    assert [r["loss"] for r in full["records"][2:]] == \
        [r["loss"] for r in rest["records"]]
