"""The port's checkpoint manager against ``repro``'s on the CPU.

Contracts (``repro``'s ``tests/test_fault_tolerance.py``):

* a restored state resumes bitwise; keep-N collects old steps; a partial
  write is invisible; an async save's failure reaches ``wait()`` and the
  next ``save()``; step directories honour the umask; the host payload
  rides in the same step, is pickled eagerly and is optional;
* the ``state.npz`` keys are ``repro``'s pytree paths: a ``ServiceState``
  (and dicts, lists, tuples, named tuples) flattens to the keys
  ``repro``'s manager writes for the same content, and the arrays cross
  both ways -- ``repro`` restores the port's files and the port restores
  ``repro``'s;
* a restore takes the template leaf's device and dtype, and a leaf missing
  from the file keeps the template's value.
"""
import collections
import json
import os
import pickle

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as tmod
from repro_torch.service.state import ServiceState

NT = collections.namedtuple("NT", "a b")


def _tree(rng, lib):
    """A nested tree of every container kind, the same numbers in numpy,
    torch or jax arrays."""
    def arr(*shape, dtype=np.float32):
        return lib(rng.standard_normal(shape).astype(dtype))
    return {"w": arr(3, 2), "x": [NT(arr(4), None), (arr(1), arr(2))],
            "y": {"z": lib(np.arange(5, dtype=np.int32)),
                  "flag": lib(np.array([True, False]))}}


def _step(state):
    """A deterministic update in float32 (a stand-in for a training step:
    any change of bits would show after a few)."""
    w, v = state["w"], state["v"]
    v = 0.9 * v + torch.tanh(w) * 0.01
    return {"w": w - v * 0.5 + torch.sin(w) * 1e-3, "v": v,
            "n": state["n"] + 1}


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.standard_normal((8, 16))
                                  .astype(np.float32)),
            "v": torch.zeros(8, 16), "n": torch.zeros((), dtype=torch.int32)}


def _service_state_numpy(seed=3):
    """A ServiceState's fields with nonzero content, as numpy."""
    rng = np.random.default_rng(seed)
    M, N, B = 3, 4, 16
    return dict(
        demand=rng.random((M, N, B)).astype(np.float32),
        arrival=rng.random((M, N)).astype(np.float32),
        loss=rng.random((M, N)).astype(np.float32),
        spawn_tick=rng.integers(0, 9, (M, N)).astype(np.int32),
        done=rng.random((M, N)) < 0.5,
        weight=rng.random(M).astype(np.float32),
        block_budget=rng.random(B).astype(np.float32),
        block_capacity=rng.random(B).astype(np.float32),
        block_birth=rng.integers(-1, 5, B).astype(np.int32),
        lam=rng.random(B).astype(np.float32),
        tick=np.asarray(7, np.int32))


class TestManagerContract:
    def test_bitwise_resume(self, tmp_path):
        state = _state()
        mgr = CheckpointManager(str(tmp_path), keep_n=2)
        for _ in range(3):
            state = _step(state)
        mgr.save(3, state)
        ref = state
        for _ in range(2):
            ref = _step(ref)
        restored, at = mgr.restore(_state(seed=1))     # other values
        assert at == 3
        for _ in range(2):
            restored = _step(restored)
        for k in ref:
            assert torch.equal(ref[k], restored[k]), k

    def test_keep_n_gc(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_n=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, {"x": torch.ones(3) * s})
        assert mgr.all_steps() == [3, 4]
        assert mgr.latest_step() == 4

    def test_partial_write_is_invisible(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_n=3)
        mgr.save(1, {"x": torch.ones(3)})
        crash = tmp_path / ".tmp_crashed"       # a writer that died
        crash.mkdir()
        (crash / "state.npz").write_bytes(b"garbage")
        (tmp_path / "step_0000000009").mkdir()  # no meta.json: not a step
        assert mgr.all_steps() == [1]
        got, at = mgr.restore({"x": torch.zeros(3)})
        assert at == 1 and torch.equal(got["x"], torch.ones(3))

    def test_async_save(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_n=2, async_save=True)
        mgr.save(7, {"x": torch.arange(4.0)})
        mgr.wait()
        got, at = mgr.restore({"x": torch.zeros(4)})
        assert at == 7 and torch.equal(got["x"], torch.arange(4.0))

    def test_async_save_failure_reaches_wait(self, tmp_path, monkeypatch):
        def boom(*a, **k):
            raise OSError("disk full")

        monkeypatch.setattr(tmod.np, "savez", boom)
        mgr = CheckpointManager(str(tmp_path), async_save=True)
        mgr.save(1, {"x": torch.ones(2)})
        with pytest.raises(OSError, match="disk full"):
            mgr.wait()
        mgr.wait()                      # consumed: idempotent afterwards
        assert mgr.all_steps() == []    # the failed step never renamed in
        assert not [p for p in os.listdir(tmp_path)
                    if p.startswith(".tmp_")]

    def test_async_save_failure_reaches_next_save(self, tmp_path,
                                                  monkeypatch):
        real = tmod.np.savez
        calls = {"n": 0}

        def flaky(*a, **k):
            calls["n"] += 1
            if calls["n"] == 1:
                raise OSError("transient")
            return real(*a, **k)

        monkeypatch.setattr(tmod.np, "savez", flaky)
        mgr = CheckpointManager(str(tmp_path), async_save=True)
        mgr.save(1, {"x": torch.ones(2)})
        with pytest.raises(OSError, match="transient"):
            mgr.save(2, {"x": torch.ones(2)})
        mgr.save(3, {"x": torch.ones(2)})
        mgr.wait()
        assert mgr.all_steps() == [3]

    def test_checkpoint_dir_honors_umask(self, tmp_path):
        old = os.umask(0o022)
        try:
            CheckpointManager(str(tmp_path)).save(1, {"x": torch.ones(2)})
        finally:
            os.umask(old)
        mode = os.stat(tmp_path / "step_0000000001").st_mode & 0o777
        assert mode == 0o755, oct(mode)

    def test_host_payload_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        host = {"free": [3, 1, 2], "fifo": collections.deque(["a", "b"]),
                "rng": np.random.default_rng(5).bit_generator.state}
        mgr.save(4, {"x": torch.arange(3.0)}, metadata={"who": "test"},
                 host_state=host)
        got, back, at = mgr.restore({"x": torch.zeros(3)}, with_host=True)
        assert at == 4 and torch.equal(got["x"], torch.arange(3.0))
        assert back["free"] == [3, 1, 2]
        assert list(back["fifo"]) == ["a", "b"]
        assert back["rng"] == host["rng"]
        meta = json.loads((tmp_path / "step_0000000004" /
                           "meta.json").read_text())
        assert meta == {"step": 4, "who": "test"}

    def test_async_save_snapshots_eagerly(self, tmp_path):
        """Both halves are snapshots at save(): the payload is pickled and
        the arrays copied off the caller's tensors before it returns."""
        mgr = CheckpointManager(str(tmp_path), async_save=True)
        host = {"pending": [1, 2, 3]}
        x = torch.ones(2)
        mgr.save(1, {"x": x}, host_state=host)
        host["pending"].append(99)      # post-save mutations must not leak
        x.add_(41.0)
        mgr.wait()
        got, back, _ = mgr.restore({"x": torch.zeros(2)}, with_host=True)
        assert back["pending"] == [1, 2, 3]
        assert torch.equal(got["x"], torch.ones(2))

    def test_restore_without_host_payload(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(2, {"x": torch.ones(2)})
        _, host, at = mgr.restore({"x": torch.zeros(2)}, with_host=True)
        assert at == 2 and host is None

    def test_restore_with_nothing_saved(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        assert mgr.restore({"x": torch.zeros(2)}) == (None, None)
        assert mgr.restore({"x": torch.zeros(2)}, with_host=True) == \
            (None, None, None)

    def test_restore_takes_template_dtype_and_keeps_missing_leaves(
            self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"x": torch.arange(3, dtype=torch.float32)})
        tmpl = {"x": torch.zeros(3, dtype=torch.float64),
                "new": torch.full((2,), 5.0), "arr": np.ones(2, np.int64)}
        got, _ = mgr.restore(tmpl)
        assert got["x"].dtype == torch.float64
        assert got["x"].tolist() == [0.0, 1.0, 2.0]
        assert got["new"] is tmpl["new"]        # v1-style missing leaf
        assert got["arr"] is tmpl["arr"]


class TestReproFormat:
    """The on-disk format is repro's: same keys, arrays both ways."""

    def test_tree_paths_match_repros(self):
        import jax.numpy as jnp
        from repro.checkpoint.manager import _flatten as jflatten
        ja = jflatten(_tree(np.random.default_rng(0), jnp.asarray))
        ta = tmod._flatten(_tree(np.random.default_rng(0), torch.from_numpy))
        assert sorted(ja) == sorted(ta)
        for k in ja:
            assert ja[k].dtype == ta[k].dtype, k
            np.testing.assert_array_equal(ja[k], ta[k], err_msg=k)

    def test_service_state_keys_match_repros(self, tmp_path):
        import jax.numpy as jnp
        from repro.checkpoint import CheckpointManager as JM
        from repro.service.state import ServiceState as JState
        fields = _service_state_numpy()
        jm, tm = JM(str(tmp_path / "j")), CheckpointManager(
            str(tmp_path / "t"))
        jm.save(7, JState(**{k: jnp.asarray(v) for k, v in fields.items()}))
        tm.save(7, ServiceState(**{k: torch.from_numpy(np.asarray(v))
                                   for k, v in fields.items()}))
        with np.load(tmp_path / "j/step_0000000007/state.npz") as zj, \
                np.load(tmp_path / "t/step_0000000007/state.npz") as zt:
            assert sorted(zj.files) == sorted(zt.files)
            assert sorted(zt.files) == sorted(f"a:{k}" for k in fields)
            for k in zj.files:
                assert zj[k].dtype == zt[k].dtype, k
                np.testing.assert_array_equal(zj[k], zt[k], err_msg=k)

    def test_repro_restores_the_ports_arrays(self, tmp_path):
        import jax.numpy as jnp
        from repro.checkpoint import CheckpointManager as JM
        from repro.service.state import ServiceState as JState
        fields = _service_state_numpy()
        CheckpointManager(str(tmp_path)).save(
            7, ServiceState(**{k: torch.from_numpy(np.asarray(v))
                               for k, v in fields.items()}))
        tmpl = JState.create(3, 4, 16)
        got, at = JM(str(tmp_path)).restore(tmpl)
        assert at == 7
        for k, v in fields.items():
            np.testing.assert_array_equal(np.asarray(getattr(got, k)), v,
                                          err_msg=k)
            assert np.asarray(getattr(got, k)).dtype == \
                jnp.asarray(getattr(tmpl, k)).dtype

    def test_port_restores_repros_arrays(self, tmp_path):
        import jax.numpy as jnp
        from repro.checkpoint import CheckpointManager as JM
        from repro.service.state import ServiceState as JState
        fields = _service_state_numpy()
        JM(str(tmp_path)).save(
            7, JState(**{k: jnp.asarray(v) for k, v in fields.items()}))
        tmpl = ServiceState.create(3, 4, 16, device="cpu")
        got, at = CheckpointManager(str(tmp_path)).restore(tmpl)
        assert at == 7
        for k, v in fields.items():
            t = getattr(got, k)
            assert t.dtype == getattr(tmpl, k).dtype, k
            np.testing.assert_array_equal(t.numpy(), v, err_msg=k)

    def test_repros_service_payload_loads_as_port_classes(self, tmp_path):
        """repro pickles its Submission inside the queue; the port's
        loader hands back the port's class with the same fields."""
        from repro.checkpoint import CheckpointManager as JM
        from repro.service.traces import Submission as JSub
        from repro_torch.service.traces import Submission as TSub
        sub = JSub(analyst=2, submit_tick=5,
                   bids=[np.arange(3, dtype=np.int64)],
                   eps=[np.full(3, 0.25, np.float32)],
                   loss=np.full(1, 0.5, np.float32))
        JM(str(tmp_path)).save(1, {"x": np.ones(1)},
                               host_state={"pending": [sub]})
        _, host, _ = CheckpointManager(str(tmp_path)).restore(
            {"x": np.zeros(1)}, with_host=True)
        back = host["pending"][0]
        assert type(back) is TSub
        assert (back.analyst, back.submit_tick) == (2, 5)
        np.testing.assert_array_equal(back.bids[0], sub.bids[0])

    def test_payload_unpickler_maps_only_service_and_obs(self):
        blob = pickle.dumps({"q": [1]})
        u = tmod._PortUnpickler(__import__("io").BytesIO(blob))
        assert u.find_class("repro.service.queue", "AdmissionStats") \
            .__module__ == "repro_torch.service.queue"
        assert u.find_class("repro.obs.registry", "MetricsRegistry") \
            .__module__ == "repro_torch.obs.registry"
        assert u.find_class("numpy", "ndarray") is np.ndarray
        for mod in ("repro.core.scheduler", "repro", "repro.shard.state"):
            with pytest.raises(pickle.UnpicklingError, match="repro_torch"):
                u.find_class(mod, "Anything")
