"""Training checkpoints and the training launcher on the CPU: a resumed run
is bitwise the uninterrupted one, a training state's checkpoint paths,
``repro``'s checkpoint resumed in the port, and the FL launcher's saves.

Contracts:

* ``tests/test_fault_tolerance.py::TestCheckpoint::test_bitwise_resume``
  for the port's ``train_step`` with noise on: the noise generator is
  seeded from (seed, step) alone, so a restored state replays the same
  steps bit for bit (parameters and every optimizer leaf);
* ``launch/train.run`` (``--smoke --device cpu``) cut at a
  ``--ckpt-every`` boundary and resumed equals the uninterrupted run:
  every step's metrics and the final state;
* a model in a checkpoint is ``d:<name>`` per parameter under its dict
  key, and restores as a new model whose parameters are views of its
  flat buffer;
* a state written by ``repro``'s ``CheckpointManager`` after ``repro``'s
  ``train_step`` (noise 0) restores through the port's manager and
  ``params_from_jax``; after the next AdamW step the parameters agree
  with ``repro``'s within 1e-5 of the largest |parameter| (a mis-mapped
  m, v or master would move them by ~lr = 1e-3; Adam's normalisation
  turns a gradient's rounding into ~1e-7 where the gradient is tiny),
  and m and v within 1e-5 of their largest entry.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch, reduced
from repro_torch.launch import fl_e2e
from repro_torch.launch import train as launcher
from repro_torch.models import params_from_jax
from repro_torch.training import (DPConfig, TrainConfig, make_state,
                                  train_step)

CFG = reduced(get_arch("flaas-100m"))
TCFG = TrainConfig(optimizer="adamw", lr=1e-3, param_dtype="float32",
                   dp=DPConfig(clip=1.0, noise_multiplier=0.1, n_micro=2))


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


def _batch(i):
    t = np.random.default_rng(i).integers(0, CFG.vocab, (4, 17))
    return {"tokens": torch.from_numpy(t[:, :-1]),
            "labels": torch.from_numpy(t[:, 1:])}


def _leaves(state):
    """Every tensor of a training state, by checkpoint-style path."""
    out = {f"params|{k}": p.detach() for k, p in
           state["params"].named_parameters()}
    for part in ("m", "v", "master"):
        out.update({f"{part}|{k}": t for k, t in state["opt"][part].items()})
    out.update(count=state["opt"]["count"], step=state["step"])
    return out


def _assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert torch.equal(la[k], lb[k]), k


def test_bitwise_resume(tmp_path):
    state = make_state(0, CFG, TCFG, device="cpu")
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for i in range(3):
        state, _ = train_step(state, _batch(i), CFG, TCFG)
    mgr.save(3, state)
    ref = state                      # the model is updated in place
    noisy = []
    for i in range(3, 5):
        ref, m = train_step(ref, _batch(i), CFG, TCFG)
        noisy.append(float(m["loss"]))
    restored, at = mgr.restore(make_state(0, CFG, TCFG, device="cpu"))
    assert at == 3 and restored["params"] is not ref["params"]
    replay = restored
    for i in range(3, 5):
        replay, m = train_step(replay, _batch(i), CFG, TCFG)
        assert float(m["loss"]) == noisy[i - 3]
    _assert_states_equal(replay, ref)
    # the noise is on: the same steps without it end elsewhere
    quiet = TrainConfig(optimizer="adamw", lr=1e-3, param_dtype="float32",
                        dp=DPConfig(clip=1.0, noise_multiplier=0.0,
                                    n_micro=2))
    other, _ = mgr.restore(make_state(0, CFG, TCFG, device="cpu"))
    for i in range(3, 5):
        other, _ = train_step(other, _batch(i), CFG, quiet)
    assert not torch.equal(other["params"].flat, ref["params"].flat)


def test_checkpoint_paths_and_views(tmp_path):
    state = make_state(0, CFG, TCFG, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state)
    with np.load(tmp_path / "step_0000000000" / "state.npz") as z:
        keys = set(z.files)
    names = [k for k, _ in state["params"].named_parameters()]
    want = {f"d:params|d:{k}" for k in names} | {"d:seed", "d:step",
                                                   "d:opt|d:count"}
    want |= {f"d:opt|d:{part}|d:{k}" for part in ("m", "v", "master")
             for k in names}
    assert keys == want
    back, _ = mgr.restore(state)
    model = back["params"]
    assert model is not state["params"]
    assert torch.equal(model.flat, state["params"].flat)
    base, end = model.flat.data_ptr(), model.flat.data_ptr() + \
        4 * model.flat.numel()
    assert all(base <= p.data_ptr() < end for p in model.parameters())
    with torch.no_grad():
        model.flat.zero_()
    assert all(not p.any() for p in model.parameters())


def test_launcher_resume_is_bitwise(tmp_path):
    kw = dict(smoke=True, device="cpu", ckpt_every=2, log=None)
    full = launcher.run(steps=4, ckpt=str(tmp_path / "a"), **kw)
    first = launcher.run(steps=2, ckpt=str(tmp_path / "b"), **kw)
    rest = launcher.run(steps=2, ckpt=str(tmp_path / "b"), **kw)
    assert full["resumed_from"] is None and first["resumed_from"] is None
    assert rest["resumed_from"] == 2
    assert full["checkpoints"] == [2, 4] == rest["checkpoints"]
    strip = [{k: v for k, v in r.items() if k != "wall_s"}
             for r in first["records"] + rest["records"]]
    assert strip == [{k: v for k, v in r.items() if k != "wall_s"}
                     for r in full["records"]]
    assert [r["step"] for r in full["records"]] == [0, 1, 2, 3]
    _assert_states_equal(rest["state"], full["state"])
    assert full["tcfg"].dp.noise_multiplier == 0.2      # repro's defaults
    assert full["tcfg"].dp.n_micro == 2 and full["tcfg"].optimizer == "adamw"


def test_launcher_raises_where_it_cannot_run(tmp_path):
    """The production mesh needs its 256 / 512 ranks; one process takes
    repro's host mesh under --multi-pod, float32, bitwise the unsharded
    run (one step)."""
    from repro_torch.launch.mesh import make_production_mesh
    for multi_pod in (False, True):
        with pytest.raises(ValueError, match="ranks"):
            make_production_mesh(multi_pod=multi_pod)
    kw = dict(smoke=True, device="cpu", steps=1, ckpt_every=1, log=None)
    host = launcher.run(multi_pod=True, ckpt=str(tmp_path / "h"), **kw)
    plain = launcher.run(ckpt=str(tmp_path / "p"), **kw)
    assert host["tcfg"].param_dtype == "float32"
    assert [{k: v for k, v in r.items() if k != "wall_s"}
            for r in host["records"]] == \
        [{k: v for k, v in r.items() if k != "wall_s"}
         for r in plain["records"]]
    assert torch.equal(host["state"]["params"].flat,
                       plain["state"]["params"].flat)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            launcher.run(smoke=True, ckpt=str(tmp_path), log=None)


def test_fl_e2e_saves_pipeline_state(tmp_path):
    """--ckpt: pipeline (0, 0)'s state after round 3 (every 4th round),
    restored bitwise into a fresh state."""
    out = fl_e2e.run(rounds=4, devices=4, analysts=1, pipes=2, small=True,
                     seq=16, device="cpu", ckpt=str(tmp_path))
    assert out["checkpoints"] == [3]
    p00 = out["pipelines"][(0, 0)]["state"]
    mgr = CheckpointManager(str(tmp_path))
    back, at = mgr.restore(make_state(5, out["cfg"], TrainConfig(
        param_dtype="float32"), device="cpu"))
    assert at == 3
    _assert_states_equal(back, p00)


def test_repro_checkpoint_resumes_in_the_port(tmp_path):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.checkpoint import CheckpointManager as JManager
    from repro.training import DPConfig as JDP
    from repro.training import TrainConfig as JTC
    from repro.training import make_state as jmake_state
    from repro.training import train_step as jtrain_step
    dp = dict(clip=1.0, noise_multiplier=0.0, n_micro=2)
    jt = JTC(optimizer="adamw", lr=1e-3, param_dtype="float32", dp=JDP(**dp))
    tt = TrainConfig(optimizer="adamw", lr=1e-3, param_dtype="float32",
                     dp=DPConfig(**dp))
    jstep = jax.jit(functools.partial(jtrain_step, cfg=CFG, tcfg=jt))

    def jb(i):
        return {k: jnp.asarray(v.numpy()) for k, v in _batch(i).items()}
    jstate = jmake_state(jax.random.PRNGKey(0), CFG, jt)
    jstate, _ = jstep(jstate, jb(0))
    JManager(str(tmp_path)).save(1, jstate)
    jnext, jm = jstep(jstate, jb(1))

    template = jax.tree.map(np.asarray, jax.device_get(jstate))
    tree, at = CheckpointManager(str(tmp_path)).restore(template)
    assert at == 1

    def named(t):
        model = params_from_jax(t, CFG, device="cpu")
        return model, {k: p.detach().clone()
                       for k, p in model.named_parameters()}
    model, _ = named(tree["params"])
    opt = {part: named(tree["opt"][part])[1] for part in ("m", "v", "master")}
    opt["count"] = torch.tensor(int(tree["opt"]["count"]), dtype=torch.int32)
    state = {"params": model, "opt": opt,
             "step": torch.tensor(int(tree["step"]), dtype=torch.int32),
             "seed": 0}
    start = model.flat.clone()
    state, m = train_step(state, _batch(1), CFG, tt)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= \
        1e-5 * abs(float(jm["loss"]))
    assert int(state["step"]) == int(jnext["step"]) == 2
    nxt = jax.device_get(jnext)

    def flat(t):
        return params_from_jax(t, CFG, device="cpu").flat
    want = flat(nxt["params"])
    assert float((want - start).abs().max()) > 1e-4       # the step moved
    err = float((state["params"].flat - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())
    for part in ("m", "v"):
        got = torch.cat([t.reshape(-1) for t in state["opt"][part].values()])
        want = flat(nxt["opt"][part])
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max()), part
