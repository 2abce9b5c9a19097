"""The sharded training step, checkpoints across layouts and GPipe
``pipeline_apply`` on 4 Gloo ranks on the CPU, against the one-rank port
and ``repro``.

The ranks are spawned once for the module (:func:`ranks`): they import
``repro_torch`` only and run every case of
:mod:`repro_torch.launch.sharded_train`; ``repro``'s references and the
one-rank port run here, in the test process, on the same numpy inputs.

Contracts (meshes (data 2, model 2) and (pod 2, data 1, model 2)):

* reduced ``flaas-100m`` (B=8, S=16, two microbatches, AdamW, lr 1e-3),
  microbatch and example mode, noise 0 and 0.2, from ``repro``'s
  parameters: against the one-rank port, loss and ``grad_norm_mean``
  within 1e-5 relative at both steps, the gradients before the optimizer
  (noise off: the noise is the one-rank draw by construction) within
  1e-5 of each leaf's largest |g|, the parameters after two steps
  within 2 lr (Adam's bound, ``PERF.md`` §2); against ``repro``'s
  one-device ``train_step`` the first step's loss within 1e-5 relative
  (``repro``'s own sharded test allows 1e-3), and at two microbatches
  the gradients (noise off) within 1e-5 of each leaf's largest |g| and,
  without noise, the parameters after two steps within 2 lr;
* reduced ``recurrentgemma-2b`` at (data 1, model 2): the ``rec``
  blocks' channels split, the single kv head gathered; reduced
  ``mixtral-8x22b`` (AdamW) and ``kimi-k2-1t-a32b`` (Adafactor without a
  master) at (2, 2) with ``arch_for_mesh``'s config, against the one-rank
  port of that config, within the same bounds;
* at mesh (1, 1) the sharded path is bitwise the unsharded step (no
  process group needed: in this process), AdamW and Adafactor, both
  modes, with noise;
* checkpoints: the launcher's checkpoint written under (2, 2) restores
  under one rank, and one written under one rank restores under (2, 2),
  the gathered state bitwise the saved one; a run resumed under the mesh
  it was saved from is bitwise the uninterrupted run (records,
  parameters, optimizer state);
* ``launch/train.py``'s rule: in a 4-rank world the host mesh and
  bfloat16 parameters;
* ``pipeline_apply`` over 4 ranks on 'pod', ``(n_stages, n_micro, d) =
  (4, 8, 16)``, ``tanh(h @ w)``: within 1e-5 of the sequential
  application in torch and in ``jnp``;
* ``kernels/ops.py``: each ``*_op`` on CPU tensors equals its module's
  function.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import sharded_train
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharded_service import spawn
from repro_torch.launch.specs import arch_for_mesh
from repro_torch.models import params_from_jax
from repro_torch.training import DPConfig, TrainConfig, make_state, train_step

B, S, LR = 8, 16, 1e-3
FLAAS = reduced(get_arch("flaas-100m"))
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
# (mesh, DP mode, noise, microbatches): both modes with and without noise
# on both meshes, then the units that span both DP ranks (one microbatch
# of all 8 rows; DP mode "none")
FLAAS_CASES = [(m, mode, noise, 2) for m in MESHES
               for mode in ("microbatch", "example")
               for noise in (0.0, 0.2)] + [("2x2", "microbatch", 0.2, 1),
                                           ("2x2", "none", 0.0, 1)]
RG = reduced(get_arch("recurrentgemma-2b"))
MOE = {n: arch_for_mesh(reduced(get_arch(n)), type("M", (), dict(
    axis_names=("data", "model"), shape={"data": 2, "model": 2})),
    ShapeSpec("train", S, B, "train"))
    for n in ("mixtral-8x22b", "kimi-k2-1t-a32b")}
PIPE = dict(n_stages=4, n_micro=8, d=16)


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


def _tcfg(mode="microbatch", noise=0.0, optimizer="adamw", keep_master=True,
          n_micro=2, param_dtype="float32"):
    return TrainConfig(optimizer=optimizer, lr=LR, param_dtype=param_dtype,
                       keep_master=keep_master,
                       dp=DPConfig(clip=1.0, noise_multiplier=noise,
                                   mode=mode, n_micro=n_micro))


def _batches(cfg, seed=0, n=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


@functools.lru_cache(maxsize=None)
def _repro_params():
    import jax
    import jax.numpy as jnp
    from repro.models import init_model
    return jax.device_get(init_model(jax.random.PRNGKey(0), FLAAS,
                                     dtype=jnp.float32))


def _flaas_params():
    model = params_from_jax(_repro_params(), FLAAS, device="cpu")
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def _one_rank(cfg, tcfg, batches, params=None):
    """The one-rank port: gradients before the first step's optimizer,
    each step's metrics, the final state."""
    job = dict(cfg=cfg, tcfg=tcfg, params=params)
    state = sharded_train._job_state(job, torch.device("cpu"))
    tb = [{k: torch.as_tensor(v) for k, v in b.items()} for b in batches]
    g, _ = sharded_train._grads(state, tb[0], cfg, tcfg, "cpu")
    recs = []
    for b in tb:
        state, m = train_step(state, b, cfg, tcfg)
        recs.append({k: float(v) for k, v in m.items()})
    return g, recs, state


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on one spawn of 4 Gloo ranks: rank 0's results, and
    the one-rank checkpoint the ranks restore."""
    tmp = tmp_path_factory.mktemp("dist")
    params = _flaas_params()
    todo = [("train", dict(cfg=FLAAS, tcfg=_tcfg(mode, noise, n_micro=n),
                           mesh=MESHES[m], params=params, grads=True,
                           batches=_batches(FLAAS)))
            for m, mode, noise, n in FLAAS_CASES]
    todo.append(("train", dict(cfg=RG, tcfg=_tcfg(noise=0.2), grads=True,
                               mesh=((1, 2), ("data", "model")),
                               batches=_batches(RG))))
    todo.append(("train", dict(cfg=MOE["mixtral-8x22b"], grads=True,
                               tcfg=_tcfg(noise=0.2), mesh=MESHES["2x2"],
                               batches=_batches(FLAAS))))
    todo.append(("train", dict(cfg=MOE["kimi-k2-1t-a32b"], grads=True,
                               tcfg=_tcfg(noise=0.2, optimizer="adafactor",
                                          keep_master=False),
                               mesh=MESHES["2x2"],
                               batches=_batches(FLAAS))))
    todo.append(("train", dict(cfg=FLAAS, grads=True, mesh=MESHES["2x2"],
                               tcfg=_tcfg(param_dtype="bfloat16"),
                               batches=_batches(FLAAS))))
    # checkpoints: saved under (2, 2); saved under one rank (here) and
    # restored under (2, 2); resumed under (2, 2)
    run = dict(smoke=True, batch=B, seq=S, param_dtype="float32")
    one = launcher.run(steps=2, ckpt_every=2, ckpt=str(tmp / "one"),
                       device="cpu", log=None, **run)
    todo += [("launcher", dict(mesh=MESHES["2x2"], run=dict(
                 steps=2, ckpt_every=2, ckpt=str(tmp / "mesh"), **run))),
             ("launcher", dict(mesh=MESHES["2x2"], run=dict(
                 steps=0, ckpt=str(tmp / "one"), **run))),
             ("launcher", dict(mesh=MESHES["2x2"], run=dict(
                 steps=4, ckpt_every=2, ckpt=str(tmp / "whole"), **run))),
             ("launcher", dict(mesh=MESHES["2x2"], run=dict(
                 steps=2, ckpt_every=2, ckpt=str(tmp / "cut"), **run))),
             ("launcher", dict(mesh=MESHES["2x2"], run=dict(
                 steps=2, ckpt_every=2, ckpt=str(tmp / "cut"), **run))),
             ("rule", {})]
    rng = np.random.default_rng(0)
    w = (0.3 * rng.standard_normal((PIPE["n_stages"], PIPE["d"],
                                    PIPE["d"]))).astype(np.float32)
    x = rng.standard_normal((PIPE["n_micro"], 4, PIPE["d"])
                            ).astype(np.float32)
    todo.append(("pipeline", dict(n_stages=PIPE["n_stages"], w=w, x=x)))
    todo += [("init", dict(cfg=cfg, tcfg=tcfg, mesh=m))
             for cfg, tcfg, m in INIT_CASES]
    res = spawn(sharded_train.jobs, 4, backend="gloo", device="cpu",
                args=(todo,), timeout=900)
    out = res[0]
    flaas = dict(zip(FLAAS_CASES, out[:len(FLAAS_CASES)]))
    rest = out[len(FLAAS_CASES):]
    return dict(flaas=flaas, params=params, rg=rest[0],
                moe=dict(zip(MOE, rest[1:3])), bf16=rest[3],
                saved_mesh=rest[4], restored=rest[5], whole=rest[6],
                cut=rest[7:9], rule=[r[len(FLAAS_CASES) + 9] for r in res],
                pipeline=rest[10],
                init=[r[len(FLAAS_CASES) + 11:] for r in res],
                w=w, x=x, one=one, tmp=tmp, all_ranks=res)


# make_state under a mesh against the cut full state: (config, training
# config, mesh)
INIT_CASES = [
    (FLAAS, _tcfg(), MESHES["2x2"]), (FLAAS, _tcfg(), MESHES["2x1x2"]),
    (FLAAS, _tcfg(param_dtype="bfloat16"), MESHES["2x2"]),
    (MOE["kimi-k2-1t-a32b"], _tcfg(optimizer="adafactor",
                                   keep_master=False), MESHES["2x2"]),
    (RG, _tcfg(optimizer="adafactor"), ((1, 2), ("data", "model")))]


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _check_against(got, g1, recs1, state1):
    """A spawned run against the one-rank port's."""
    for n, want in g1.items():
        scale = max(float(want.abs().max()), 1e-30)
        err = float((got["grads"][n] - want).abs().max())
        assert err <= 1e-5 * scale, (n, err, scale)
    for a, b in zip(got["records"], recs1):
        for k in ("loss", "grad_norm_mean"):
            assert _rel(a[k], b[k]) <= 1e-5, (k, a[k], b[k])
    for n, p in state1["params"].named_parameters():
        err = float((got["state"]["params"][n] - p.detach()).abs().max())
        assert err <= 2 * LR, (n, err)


@pytest.mark.parametrize("case", FLAAS_CASES, ids=lambda c: "-".join(
    map(str, c)))
def test_flaas_sharded_step_matches_one_rank(ranks, case):
    mesh, mode, noise, n_micro = case
    g1, recs1, state1 = _one_rank(FLAAS, _tcfg(mode, noise, n_micro=n_micro),
                                  _batches(FLAAS), ranks["params"])
    _check_against(ranks["flaas"][case], g1, recs1, state1)


@functools.lru_cache(maxsize=None)
def _repro_reference(mode):
    """repro's one-device step (jitted) on the same numpy parameters and
    batches, noise off: the first step's loss, the gradients before the
    first step's optimizer and the parameters after two steps, by the
    port's names."""
    import jax
    import jax.numpy as jnp
    from repro.training import train_loop as jtl
    jt = jtl.TrainConfig(optimizer="adamw", lr=LR, param_dtype="float32",
                         dp=jtl.DPConfig(clip=1.0, noise_multiplier=0.0,
                                         mode=mode, n_micro=2))
    state = jtl.make_state(jax.random.PRNGKey(0), FLAAS, jt)
    state["params"] = _repro_params()
    bs = [{k: jnp.asarray(v) for k, v in b.items()}
          for b in _batches(FLAAS)]
    loss_fn = jtl.make_loss_fn(FLAAS)
    (g, _), _ = jax.jit(lambda p, b: jtl._grads_with_loss(
        loss_fn, p, b, jax.random.PRNGKey(0), jt))(state["params"], bs[0])
    step = jax.jit(functools.partial(jtl.train_step, cfg=FLAAS, tcfg=jt))
    losses = []
    for b in bs:
        state, m = step(state, b)
        losses.append(float(m["loss"]))

    def named(tree):
        model = params_from_jax(jax.device_get(tree), FLAAS, device="cpu")
        return {n: p.detach() for n, p in model.named_parameters()}
    return losses[0], named(g), named(state["params"])


@pytest.mark.parametrize("mode", ["microbatch", "example"])
def test_flaas_sharded_loss_matches_repro(ranks, mode):
    """repro's one-device train_step on the same numpy parameters and
    batches: the first step's loss (which noise does not reach) within
    1e-5 relative in every mesh and noise; at two microbatches (repro's
    clipping units) the gradients before the first step's optimizer
    (noise off) within 1e-5 of each leaf's largest |g|, and without
    noise the parameters after two steps within 2 lr."""
    want, g, params = _repro_reference(mode)
    seen = 0
    for (mesh, md, noise, n_micro), got in ranks["flaas"].items():
        if md != mode:
            continue
        assert _rel(got["records"][0]["loss"], want) <= 1e-5, \
            (mesh, noise, got["records"][0]["loss"], want)
        if n_micro != 2:
            continue
        seen += 1
        for n, w in g.items():
            scale = max(float(w.abs().max()), 1e-30)
            err = float((got["grads"][n] - w).abs().max())
            assert err <= 1e-5 * scale, (mesh, noise, n, err, scale)
        if noise == 0.0:
            for n, w in params.items():
                err = float((got["state"]["params"][n] - w).abs().max())
                assert err <= 2 * LR, (mesh, n, err)
    assert seen == 4, seen


def test_recurrentgemma_channels_split(ranks):
    got = ranks["rg"]
    g1, recs1, state1 = _one_rank(RG, _tcfg(noise=0.2), _batches(RG))
    _check_against(got, g1, recs1, state1)
    # the rec blocks' leaves are halves on each rank, the kv head whole
    assert got["coords"]["model"] == 0


@pytest.mark.parametrize("name", sorted(MOE))
def test_moe_sharded_step_matches_one_rank(ranks, name):
    cfg = MOE[name]
    assert cfg.moe_dispatch_groups == 2
    tcfg = _tcfg(noise=0.2) if name.startswith("mixtral") else \
        _tcfg(noise=0.2, optimizer="adafactor", keep_master=False)
    g1, recs1, state1 = _one_rank(cfg, tcfg, _batches(FLAAS))
    _check_against(ranks["moe"][name], g1, recs1, state1)


def test_bfloat16_sharded_step_within_twice_the_bfloat16_distance(ranks):
    """bfloat16 parameters (repro's choice on more than one rank) at (2,
    2): the gradients and each step's loss within 2 d plus half a
    bfloat16 ulp of the one-rank bfloat16 run, d its distance from the
    one-rank float32 run on the same values (the bound of
    ``tests/test_torch_bf16_train.py``)."""
    got = ranks["bf16"]
    g16, recs16, _ = _one_rank(FLAAS, _tcfg(param_dtype="bfloat16"),
                               _batches(FLAAS))
    g32, recs32, _ = _one_rank(FLAAS, _tcfg(), _batches(FLAAS))
    flat = {k: torch.cat([g[n].reshape(-1).double() for n in g1_names])
            for k, g, g1_names in (("s", got["grads"], list(g16)),
                                   ("16", g16, list(g16)),
                                   ("32", g32, list(g16)))}
    d = float((flat["16"] - flat["32"]).abs().max())
    half_ulp = 2.0 ** -9 * float(flat["16"].abs().max())
    assert float((flat["s"] - flat["16"]).abs().max()) <= 2 * d + half_ulp
    for a, b, c in zip(got["records"], recs16, recs32):
        dl = abs(b["loss"] - c["loss"])
        assert abs(a["loss"] - b["loss"]) <= 2 * dl + 2.0 ** -9 * b["loss"]


def test_state_bytes_follow_the_rules(ranks):
    for res in ranks["all_ranks"]:
        for r in res[:len(FLAAS_CASES) + 4]:
            assert r["bytes"] == r["rule_bytes"], r["coords"]


@pytest.mark.parametrize("case", range(len(INIT_CASES)), ids=[
    f"{c.name}-{t.optimizer}-{t.param_dtype}-{'x'.join(map(str, m[0]))}"
    for c, t, m in INIT_CASES])
def test_state_made_on_the_shards_is_bitwise_the_cut_full_state(ranks, case):
    """``make_state`` under a mesh draws each leaf and keeps its shard,
    and makes the optimizer state at its ZeRO-1 slices: bitwise what
    ``shard_state`` cuts from the full state, on every rank."""
    for r in ranks["init"]:
        assert r[case]["bitwise"], (INIT_CASES[case][0].name, r[case])


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_one_by_one_mesh_is_bitwise_the_unsharded_step(optimizer):
    mesh = make_mesh((1, 1), ("data", "model"))
    for mode in ("microbatch", "example"):
        tcfg = _tcfg(mode, 0.2, optimizer)
        a = make_state(0, FLAAS, tcfg, device="cpu")
        b = make_state(0, FLAAS, tcfg, device="cpu", mesh=mesh)
        for batch in _batches(FLAAS):
            batch = {k: torch.as_tensor(v) for k, v in batch.items()}
            a, ma = train_step(a, batch, FLAAS, tcfg)
            b, mb = train_step(b, batch, FLAAS, tcfg, mesh)
            assert ma.keys() == mb.keys()
            for k in ma:
                assert torch.equal(ma[k], mb[k]), (mode, k)
        assert torch.equal(a["params"].flat, b["params"].flat), mode
        for key, v in a["opt"].items():
            if isinstance(v, dict):
                for n, t in v.items():
                    for x, y in zip(
                            t.values() if isinstance(t, dict) else [t],
                            (b["opt"][key][n].values()
                             if isinstance(t, dict) else [b["opt"][key][n]])):
                        assert torch.equal(x, y), (key, n)


def _state_equal(host, state):
    """A gathered host state bitwise a full state."""
    for n, p in state["params"].named_parameters():
        assert torch.equal(host["params"][n], p.detach()), n
    for key in ("m", "v", "master"):
        for n, t in state["opt"][key].items():
            assert torch.equal(host[key][n], t), (key, n)
    assert host["step"] == int(state["step"])


def test_checkpoint_saved_under_a_mesh_restores_under_one_rank(ranks):
    saved = ranks["saved_mesh"]
    assert saved["checkpoints"] == [2]
    template = make_state(0, FLAAS, launcher.train_config(
        FLAAS, B, 0.2, 1.0, "float32"), device="cpu")
    state, at = CheckpointManager(str(ranks["tmp"] / "mesh")).restore(
        template)
    assert at == 2
    _state_equal(saved["state"], state)


def test_checkpoint_saved_under_one_rank_restores_under_a_mesh(ranks):
    got = ranks["restored"]
    assert got["resumed_from"] == 2 and got["records"] == []
    _state_equal(got["state"], ranks["one"]["state"])


def test_resume_under_the_same_mesh_is_bitwise(ranks):
    whole, (first, rest) = ranks["whole"], ranks["cut"]
    assert rest["resumed_from"] == 2
    assert first["records"] + rest["records"] == whole["records"]
    assert whole["checkpoints"] == [2, 4] == rest["checkpoints"]
    for key in ("params", "m", "v", "master"):
        for n, t in whole["state"][key].items():
            assert torch.equal(rest["state"][key][n], t), (key, n)
    assert whole["state"]["step"] == rest["state"]["step"] == 4


def test_launcher_rule_by_world_size(ranks):
    for r in ranks["rule"]:
        assert r == {"mesh": {"data": 1, "model": 1},
                     "param_dtype": "bfloat16"}
    assert launcher.launch_dtype() == "float32"
    assert launcher.launch_mesh().shape == {"data": 1, "model": 1}


def test_pipeline_apply_matches_sequential(ranks):
    import jax.numpy as jnp
    w, x = ranks["w"], ranks["x"]
    got = ranks["pipeline"]["y"]
    want = torch.as_tensor(x)
    jwant = jnp.asarray(x)
    for s in range(PIPE["n_stages"]):
        want = torch.tanh(want @ torch.as_tensor(w[s]))
        jwant = jnp.tanh(jwant @ jnp.asarray(w[s]))
    assert got.shape == (PIPE["n_micro"], 4, PIPE["d"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-5,
                               atol=1e-5)


def test_kernel_ops_equal_their_modules():
    from repro_torch.core import hotpath
    from repro_torch.kernels import (decode_attention, dp_clip_noise,
                                     flash_attention, ops, rg_lru)
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.rand(shape, generator=g)
    q, k, v = r(2, 8, 4, 16), r(2, 8, 2, 16), r(2, 8, 2, 16)
    assert torch.equal(ops.flash_attention_op(q, k, v, window=4),
                       flash_attention.flash_attention(q, k, v, window=4))
    assert torch.equal(ops.decode_attention_op(q[:, 0], k, v, 5),
                       decode_attention.decode_attention(q[:, 0], k, v, 5))
    a, b, h0 = r(2, 8, 6), r(2, 8, 6), r(2, 6)
    assert torch.equal(ops.rglru_scan_op(a, b, h0), rg_lru.rglru_scan(a, b, h0))
    G = r(3, 40)
    for x, y in zip(ops.dp_clip_accumulate_op(G, 0.5),
                    dp_clip_noise.dp_clip_accumulate(G, 0.5)):
        assert torch.equal(x, y)
    c = r(5, 7)
    assert torch.equal(ops.rowmax_op(c), hotpath.rowmax(c))
    lam = r(7)
    assert torch.equal(ops.matvec_op(c, lam), hotpath.matvec(c, lam))
    args = (c, lam, r(5), r(5), torch.ones(5, dtype=torch.int32), r(7),
            r(7) + 0.5)
    for x, y in zip(ops.dual_step_op(*args, beta=2.2),
                    hotpath.dual_step(c, lam, args[2], 2.2, *args[3:])):
        assert torch.equal(x, y)
    go, sel, left = r(4, 6, 7), torch.tensor([1, 0, 1, 1, 0, 1]), r(4, 7)
    extras, after = ops.boost_scan_op(go[0], sel.bool(), left[0],
                                      kappa_max=2.0)
    want_left, want_extras = hotpath.boost_scan(
        go[:1], sel[None].to(torch.int32), left[:1], 2.0)
    assert torch.equal(extras, want_extras[0])
    assert torch.equal(after, want_left[0])
