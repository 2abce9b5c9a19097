"""Service checkpoints in the port, against its own runs and ``repro``'s.

Contracts (``repro``'s ``tests/test_service_checkpoint.py`` and
``tests/test_checkpoint_properties.py``):

* **bitwise resume** -- for all four schedulers, in paged and carry
  residency, a service checkpointed at a chunk boundary and restored into
  a fresh service continues bit for bit: the same per-tick outputs and
  selections, final device state and summary fingerprint as the
  uninterrupted run, through ring wraps before and after the restore;
* v1, v2 and v3 payloads (no ``weight`` leaf and no tenancy keys; no
  ``obs`` block; no ``lam`` leaf) restore and resume bitwise; an unknown
  version, a geometry mismatch, a missing payload and a missing
  checkpoint are rejected;
* **from** ``repro`` -- a service checkpoint written by ``repro`` at tick
  H restores into the port, whose ticks H..T then hold to ``repro``'s
  uninterrupted run under ``test_torch_service.py``'s rules: per-tick
  ``n_allocated``, the final grants and occupancy equal, continuous
  outputs within 1e-5, SP1 iteration counts equal but for the pinned
  near-ties (ROADMAP Queue 3);
* the telemetry reservoir resumes bitwise against an uninterrupted stream
  (checked against the port's own stream, not ``repro``'s property test,
  which fails on its own: ROADMAP caveat).
"""
import dataclasses
import json
import os
import pickle

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import SCHEDULER_NAMES, SchedulerConfig
from repro_torch.launch.sharded_service import capture_selections
from repro_torch.service import (FlaasService, ServiceConfig,
                                 collect_service_metrics, make_trace,
                                 summary_fingerprint)
from repro_torch.service.telemetry import _Reservoir

# 4 devices x 2 blocks a tick = 8 blocks a tick; the 80-slot ring covers
# 10 ticks, so 24 ticks wrap it twice (retirement in both halves)
SIZE = dict(n_devices=4, pipelines_per_analyst=6)
RING = 80
HALF, TOTAL = 12, 24
GEOMETRY = dict(analyst_slots=3, pipeline_slots=6, block_slots=RING,
                chunk_ticks=4, admit_batch=8, max_pending=64)


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


def make_service(scheduler="dpbalance", *, paged=True, seed=2, **over):
    trace = make_trace("paper_default", "poisson", seed=seed, **SIZE)
    cfg = ServiceConfig(scheduler=scheduler, sched=SchedulerConfig(beta=2.2),
                        paged=paged, **{**GEOMETRY, **over})
    return FlaasService(cfg, trace, device="cpu")


def fingerprint(service):
    return json.dumps(summary_fingerprint(service.summary()), sort_keys=True)


def run_rows(service, ticks):
    """Per-tick rows of the next ``ticks`` ticks, selections included."""
    sel = capture_selections(service)
    rows = collect_service_metrics(service, ticks)
    rows["selected"] = np.concatenate(sel)
    return rows


def assert_states_equal(a, b):
    for f in dataclasses.fields(a.state):
        assert torch.equal(getattr(a.state, f.name),
                           getattr(b.state, f.name)), f.name


def assert_rows_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                      err_msg=k)


class TestBitwiseResume:
    def _roundtrip(self, tmp_path, scheduler, paged, async_save):
        ref = make_service(scheduler, paged=paged)
        head = run_rows(ref, HALF)
        tail = run_rows(ref, TOTAL - HALF)

        crashed = make_service(scheduler, paged=paged)
        assert_rows_equal(head, run_rows(crashed, HALF))
        mgr = CheckpointManager(str(tmp_path), async_save=async_save)
        assert crashed.save_checkpoint(mgr) == HALF
        mgr.wait()

        resumed = make_service(scheduler, paged=paged)
        assert resumed.load_checkpoint(CheckpointManager(str(tmp_path))) \
            == HALF
        assert resumed.tick == HALF == int(resumed.state.tick)
        assert_rows_equal(tail, run_rows(resumed, TOTAL - HALF))
        assert_states_equal(ref, resumed)
        assert fingerprint(ref) == fingerprint(resumed)
        return resumed

    @pytest.mark.parametrize("scheduler", SCHEDULER_NAMES)
    def test_paged_mode(self, tmp_path, scheduler):
        svc = self._roundtrip(tmp_path, scheduler, True, async_save=True)
        assert svc.telemetry.mode_ticks["paged"] > 0

    @pytest.mark.parametrize("scheduler", SCHEDULER_NAMES)
    def test_carry_mode(self, tmp_path, scheduler):
        svc = self._roundtrip(tmp_path, scheduler, False, async_save=False)
        assert svc.telemetry.mode_ticks["carry"] > 0

    def test_warm_sp1_lam_leaf_resumes(self, tmp_path):
        """v4's lam leaf: the warm duals ride through the checkpoint."""
        def warm():
            trace = make_trace("paper_default", "poisson", seed=2, **SIZE)
            return FlaasService(ServiceConfig(
                scheduler="dpbalance", trace_level=1,
                sched=SchedulerConfig(beta=2.2, sp1_warm_start=True),
                **GEOMETRY), trace, device="cpu")
        ref = warm()
        ref.run(TOTAL)
        crashed = warm()
        crashed.run(HALF)
        mgr = CheckpointManager(str(tmp_path))
        crashed.save_checkpoint(mgr)
        resumed = warm()
        resumed.load_checkpoint(mgr)
        torch.testing.assert_close(resumed.state.lam, crashed.state.lam,
                                   rtol=0, atol=0)
        resumed.run(TOTAL - HALF)
        assert_states_equal(ref, resumed)
        assert fingerprint(ref) == fingerprint(resumed)
        assert [r["sp1_iters"] for r in resumed.trace_sink.records()] == \
            [r["sp1_iters"] for r in ref.trace_sink.records()][HALF:]

    def test_resume_crosses_ring_wraps(self):
        bpt = make_trace("paper_default", "poisson", seed=2,
                         **SIZE).blocks_per_tick
        assert HALF * bpt > RING                # wrap before the crash
        assert TOTAL * bpt > 2 * RING           # and after the restore

    def test_checkpoint_records_layout_and_obs(self, tmp_path):
        svc = make_service("dpf")
        svc.run(8)
        host = svc.checkpoint_host_state()
        assert host["kind"] == "flaas-service" and host["version"] == 4
        assert host["layout_shards"] == 1
        assert host["geometry"] == (3, 6, RING)
        assert set(host["obs"]) == {"registry", "profiler", "audit_slots"}
        mgr = CheckpointManager(str(tmp_path))
        svc.save_checkpoint(mgr)
        assert svc.profiler.summary()["checkpoint_save"]["calls"] == 1
        meta = json.loads((tmp_path / "step_0000000008" /
                           "meta.json").read_text())
        assert meta == {"step": 8, "scheduler": "dpf", "layout_shards": 1}


class TestRejections:
    def test_restore_requires_host_payload(self, tmp_path):
        svc = make_service()
        svc.run(4)
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(4, svc.state)                  # arrays only
        with pytest.raises(ValueError, match="no service host state"):
            make_service().load_checkpoint(mgr)

    def test_restore_rejects_geometry_mismatch(self, tmp_path):
        svc = make_service()
        svc.run(4)
        mgr = CheckpointManager(str(tmp_path))
        svc.save_checkpoint(mgr)
        trace = make_trace("paper_default", "poisson", seed=2, **SIZE)
        other = FlaasService(ServiceConfig(**{**GEOMETRY,
                                              "analyst_slots": 4}),
                             trace, device="cpu")
        with pytest.raises(ValueError, match="geometry"):
            other.load_checkpoint(mgr)

    def test_missing_checkpoint_raises(self, tmp_path):
        with pytest.raises(ValueError, match="no checkpoint"):
            make_service().load_checkpoint(CheckpointManager(str(tmp_path)))

    def test_unknown_version_rejected(self, tmp_path):
        svc = make_service()
        svc.run(4)
        mgr = CheckpointManager(str(tmp_path))
        step = svc.save_checkpoint(mgr)
        _edit_payload(tmp_path, step, lambda h: h.update(version=99))
        with pytest.raises(ValueError, match="version"):
            make_service().load_checkpoint(mgr)


def _edit_payload(ckpt_dir, step, edit):
    path = os.path.join(str(ckpt_dir), f"step_{step:010d}", "host.pkl")
    with open(path, "rb") as f:
        host = pickle.load(f)
    edit(host)
    with open(path, "wb") as f:
        pickle.dump(host, f, protocol=pickle.HIGHEST_PROTOCOL)


def _drop_leaves(ckpt_dir, step, *keys):
    npz = os.path.join(str(ckpt_dir), f"step_{step:010d}", "state.npz")
    with np.load(npz) as z:
        flat = {k: z[k] for k in z.files}
    for k in keys:
        assert k in flat, k
        del flat[k]
    np.savez(npz, **flat)


def _to_v1(host):
    """repro's v1 schema: no tenancy keys, one FIFO, Submissions without
    the tenancy fields, the telemetry without its tier maps."""
    host["version"] = 1
    for key in ("row_tier", "row_weight", "tenancy", "obs"):
        host.pop(key)
    q = host["queue"]
    pending = [s for p in sorted(q["classes"], reverse=True)
               for s in q["classes"][p]]
    for s in pending:
        for attr in ("tier", "priority", "weight", "deadline_ticks",
                     "cost_cap"):
            s.__dict__.pop(attr, None)
    host["queue"] = {"pending": pending,
                     "stats": {k: v for k, v in q["stats"].items()
                               if k not in ("rejected_deadline",
                                            "rejected_cost_cap")}}
    for key in ("tier_stats", "tenant_spend", "tenant_tier"):
        host["telemetry"].pop(key)
    host["trace"].pop("tiers")


class TestOlderPayloads:
    """Checkpoints of earlier schema versions restore with their missing
    parts at the neutral defaults and resume bitwise (the uninterrupted
    run has those defaults too: one tier, cold SP1)."""

    @pytest.mark.parametrize("version", [1, 2, 3])
    def test_restores_and_resumes_bitwise(self, tmp_path, version):
        ref = make_service("dpf")
        ref.run(8)
        mgr = CheckpointManager(str(tmp_path))
        step = ref.save_checkpoint(mgr)
        if version == 1:
            _drop_leaves(tmp_path, step, "a:weight", "a:lam")
            _edit_payload(tmp_path, step, _to_v1)
        else:
            _drop_leaves(tmp_path, step, "a:lam")
            _edit_payload(tmp_path, step, lambda h: h.update(
                version=version, **({"obs": {}} if version == 2 else {})))
        ref.run(8)

        fresh = make_service("dpf")
        assert fresh.load_checkpoint(mgr) == step
        np.testing.assert_array_equal(fresh.state.weight.numpy(),
                                      np.ones(3, np.float32))
        np.testing.assert_array_equal(fresh.state.lam.numpy(),
                                      np.ones(RING, np.float32))
        assert list(fresh._row_tier) == ["default"] * 3
        if version == 1:
            assert fresh.queue.stats.rejected_deadline == 0
            for s in fresh.queue.pending:        # class-default fallback
                assert s.tier == "default" and s.weight == 1.0
        fresh.run(8)
        assert fingerprint(fresh) == fingerprint(ref)
        assert_states_equal(ref, fresh)


# dpbalance's SP1 iterations per tick over ticks HALF..TOTAL (repro's
# uninterrupted run, the port resumed from repro's checkpoint): equal but
# at ticks 14 and 16, where the stop rule sits on its float32 noise floor
# (ROADMAP Queue 3); the selections and outputs of those ticks agree
_RESUME_TIES = ([4000, 4000, 606, 29, 4000, 44, 29, 29, 127, 29, 29, 29],
                [4000, 4000, 605, 29, 72, 44, 29, 29, 127, 29, 29, 29])


class TestFromRepro:
    """A checkpoint written by repro resumes in the port."""

    def _pair(self, scheduler, trace_level):
        import repro.service as js
        from repro.core import SchedulerConfig as JSched
        kw = dict(scheduler=scheduler, trace_level=trace_level, **GEOMETRY)

        def jsvc():
            return js.FlaasService(
                js.ServiceConfig(sched=JSched(beta=2.2), **kw),
                js.make_trace("paper_default", "poisson", seed=2, **SIZE))
        tsvc = FlaasService(
            ServiceConfig(sched=SchedulerConfig(beta=2.2), **kw),
            make_trace("paper_default", "poisson", seed=2, **SIZE),
            device="cpu")
        return jsvc, tsvc

    @pytest.mark.parametrize("scheduler", ["dpbalance", "dpf"])
    def test_repro_checkpoint_resumes_in_the_port(self, tmp_path,
                                                  scheduler):
        import repro.service as js
        from repro.checkpoint import CheckpointManager as JM
        jsvc, port = self._pair(scheduler, trace_level=1)
        # repro uninterrupted to TOTAL, keeping its per-tick rows
        ref = jsvc()
        js.collect_service_metrics(ref, HALF)
        want = js.collect_service_metrics(ref, TOTAL - HALF)
        want_iters = [r["sp1_iters"] for r in ref.trace_sink.records()]
        # repro to HALF, checkpoint
        writer = jsvc()
        writer.run(HALF)
        writer.save_checkpoint(JM(str(tmp_path)))
        # the port restores and continues
        assert port.load_checkpoint(CheckpointManager(str(tmp_path))) \
            == HALF
        got = collect_service_metrics(port, TOTAL - HALF)
        assert sorted(got) == sorted(want)
        for k in want:
            x, y = np.asarray(want[k]), np.asarray(got[k])
            if x.dtype.kind in "bi":
                np.testing.assert_array_equal(y, x, err_msg=k)
            else:
                np.testing.assert_allclose(y.astype(np.float64),
                                           x.astype(np.float64), rtol=1e-5,
                                           atol=1e-5, err_msg=k)
        # the tail's selections: the final occupancy and grants agree
        np.testing.assert_array_equal(port.state.done.numpy(),
                                      np.asarray(ref.state.done))
        np.testing.assert_array_equal(port.table.occupied,
                                      ref.table.occupied)
        got_iters = [r["sp1_iters"] for r in port.trace_sink.records()]
        if scheduler == "dpbalance":
            assert (want_iters[HALF:], got_iters) == _RESUME_TIES
        else:
            assert got_iters == want_iters[HALF:]
        assert port.summary()["grants"] == ref.summary()["grants"]


def test_reservoir_resume_matches_uninterrupted():
    """Checkpoint the latency reservoir mid-stream, restore into a fresh
    one, continue: buffer, draws and percentiles equal the uninterrupted
    stream's."""
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, 50, rng.integers(1, 40)) for _ in range(30)]
    a = _Reservoir(64, seed=9)
    for b in batches[:15]:
        a.add(b)
    resumed = _Reservoir(64, seed=1)
    resumed.load_state_dict(pickle.loads(pickle.dumps(a.state_dict())))
    for b in batches[15:]:
        a.add(b)
        resumed.add(b)
    assert a.n_seen == resumed.n_seen > 64
    np.testing.assert_array_equal(resumed.buf, a.buf)
    assert resumed.rng.bit_generator.state == a.rng.bit_generator.state
    assert resumed.percentiles((50, 90, 99)) == a.percentiles((50, 90, 99))
