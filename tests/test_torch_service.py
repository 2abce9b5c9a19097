"""The port's streaming service plane against ``repro``'s on the CPU.

The same numpy-seeded traces go through both packages (the trace
generators are numpy, so both draw the same submissions).  Contracts:

* the port's service equals the port's ``run_episode`` through
  ``replay_gap`` for every scheduler and any chunking -- exactly (0) where
  the ring is the episode's K and no analyst row recycles inside the
  window, within ``replay_gap``'s scaled 1e-5 where the ring is padded
  or rows recycle (the analyst axis is then permuted);
* per-tick outputs equal ``repro``'s service: selections, ``n_allocated``
  and ``expired`` equal, continuous outputs within rtol 1e-5 / atol 1e-5;
* the host-side pieces (``plan_mints``, ``SlotTable``, the admission
  write, the queue and the tenancy telemetry) equal ``repro``'s on the
  same inputs;
* the checkpoint methods no longer raise (their contract is
  ``test_torch_service_checkpoint.py``'s); the CUDA default is checked in
  ``test_torch_isolation.py``.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.service as js
from repro.core import SchedulerConfig as JSched
from repro_torch import service as ts
from repro_torch.core import SCHEDULER_NAMES
from repro_torch.core import SchedulerConfig as TSched
from repro_torch.service.traces import Submission

ROOT = Path(__file__).resolve().parents[1]
# small geometry: 4 devices x 2 blocks/tick = 8 blocks per tick
SIZE = dict(n_devices=4, pipelines_per_analyst=6)
DISCRETE = ("n_allocated", "selected", "expired")


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


def traces(pattern="poisson", seed=2, **extra):
    kw = dict(SIZE)
    kw.update(extra)
    return (js.make_trace("paper_default", pattern, seed=seed, **kw),
            ts.make_trace("paper_default", pattern, seed=seed, **kw))


def services(pattern="poisson", seed=3, sched_kw=None, trace_kw=None,
             **over):
    """``repro``'s service and the port's (on the CPU) over the same
    trace and config (``test_service.py``'s continuous-operation
    geometry: a minimal 80-slot ring)."""
    jt, tt = traces(pattern, seed, **(trace_kw or {}))
    kw = dict(scheduler="dpf", analyst_slots=3, pipeline_slots=6,
              block_slots=10 * jt.blocks_per_tick, chunk_ticks=8,
              admit_batch=8, max_pending=64, validate=True)
    kw.update(over)
    sk = dict(beta=2.2, **(sched_kw or {}))
    return (js.FlaasService(js.ServiceConfig(sched=JSched(**sk), **kw), jt),
            ts.FlaasService(ts.ServiceConfig(sched=TSched(**sk), **kw), tt,
                            device="cpu"))


def assert_ticks_agree(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape, k
        if k in DISCRETE or x.dtype.kind in "bi":
            np.testing.assert_array_equal(y, x, err_msg=k)
        else:
            np.testing.assert_allclose(y.astype(np.float64),
                                       x.astype(np.float64), rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def assert_summaries_agree(a, b):
    """Telemetry summaries: equal structure, integers equal, floats within
    1e-5 (wall-clock keys skipped)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            if k in ("wall_seconds", "ticks_per_second",
                     "admissions_per_second"):
                continue
            assert_summaries_agree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_summaries_agree(x, y)
    elif isinstance(a, (bool, str, type(None))) or isinstance(a, int):
        assert a == b
    else:
        np.testing.assert_allclose(float(b), float(a), rtol=1e-5,
                                   atol=1e-5, equal_nan=True)


# ----------------------------------------------------------- replay oracle
@pytest.mark.parametrize("scheduler", SCHEDULER_NAMES)
def test_replay_matches_run_episode(scheduler):
    """10 ticks x 8 blocks: the ring is the episode's K = 80, so the
    service is the engine bit for bit."""
    _, tt = traces()
    gaps = ts.replay_gap(tt, 10, TSched(beta=2.2), scheduler,
                         chunk_ticks=4, device="cpu")
    assert gaps == {k: 0.0 for k in ts.PARITY_KEYS}, gaps


@pytest.mark.parametrize("chunk", [1, 3, 10])
def test_chunking_does_not_change_metrics(chunk):
    _, tt = traces(seed=5)
    gaps = ts.replay_gap(tt, 10, TSched(), "dpf", chunk_ticks=chunk,
                         device="cpu")
    assert max(gaps.values()) == 0.0, gaps


@pytest.mark.parametrize("warm", [False, True])
def test_replay_dpbalance_any_chunking(warm):
    """Short chunks let a granted analyst's row recycle to a later
    arrival, so the service's rows are a permutation of the episode's and
    the analyst-axis sums round in another order: n_allocated stays
    equal, the rest within replay_gap's scaled 1e-5 (repro's contract)."""
    _, tt = traces("diurnal", seed=7)
    for chunk in (1, 3):
        gaps = ts.replay_gap(tt, 10, TSched(sp1_warm_start=warm),
                             "dpbalance", chunk_ticks=chunk, device="cpu")
        assert gaps["n_allocated"] == 0.0, (chunk, gaps)
        assert max(gaps.values()) <= 1e-5, (chunk, gaps)


def test_short_trace_pads_ring_to_demand_window():
    """4 ticks (K = 32) under a 40-slot demand window: the ring is padded
    with never-created slots, and replay_gap's scaled 1e-5 holds."""
    _, tt = traces(seed=9)
    gaps = ts.replay_gap(tt, 4, TSched(), "dpf", chunk_ticks=2,
                         device="cpu")
    assert max(gaps.values()) <= 1e-5, gaps


def test_freeze_trace_matches_repro():
    jt, tt = traces()
    a, b = js.freeze_trace(jt, 10), ts.freeze_trace(tt, 10, device="cpu")
    for f in ("demand", "loss", "arrival", "spawn_round", "block_budget",
              "block_round"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(a, f)), err_msg=f)
    assert a.n_rounds == b.n_rounds
    with pytest.raises(ValueError):
        ts.freeze_trace(traces("churn", seed=0)[1], 40, device="cpu")


# ------------------------------------------------- per tick against repro
@pytest.mark.parametrize("pattern,scheduler", [
    ("poisson", "dpbalance"), ("diurnal", "dpf"), ("bursty", "dpk"),
    ("churn", "fcfs"), ("churn", "dpbalance")])
def test_per_tick_metrics_match_repro(pattern, scheduler):
    """40 ticks through an 80-slot ring (4 wraps): every per-tick output
    and the summary agree with repro's service."""
    js_svc, ts_svc = services(pattern, scheduler=scheduler)
    a = js.collect_service_metrics(js_svc, 40)
    b = ts.collect_service_metrics(ts_svc, 40)
    assert_ticks_agree(a, b)
    assert_summaries_agree(js_svc.summary(), ts_svc.summary())
    np.testing.assert_array_equal(ts_svc.table.occupied,
                                  js_svc.table.occupied)
    np.testing.assert_array_equal(ts_svc.state.block_birth.numpy(),
                                  np.asarray(js_svc.state.block_birth))
    assert int(ts_svc.state.tick) == ts_svc.tick == 40


# warm dpbalance SP1 iterations per tick (repro, port) in the test below,
# where the stop rule sits on its float32 noise floor at ticks 1, 16 and
# 24 (ROADMAP Queue 3); every other tick is equal
_WARM_TIES = ([13, 99, 14] + [12] * 13 + [73, 14] + [12] * 6 + [91] +
              [12] * 15,
              [13, 110, 14] + [12] * 13 + [72, 14] + [12] * 6 + [90] +
              [12] * 15)


def test_warm_dpbalance_matches_repro():
    """Warm SP1 through wraps: the dual carry resets on every mint.
    Selections and every per-tick output agree; the SP1 iteration counts
    (per tick, from the level-1 decision trace) are the pinned near-ties,
    so the summaries agree but for the solver's iteration totals."""
    js_svc, ts_svc = services("poisson", scheduler="dpbalance",
                              sched_kw=dict(sp1_warm_start=True),
                              trace_level=1)
    assert_ticks_agree(js.collect_service_metrics(js_svc, 40),
                       ts.collect_service_metrics(ts_svc, 40))
    sa, sb = js_svc.summary(), ts_svc.summary()
    ia = [r["sp1_iters"] for r in js_svc.trace_sink.records()]
    ib = [r["sp1_iters"] for r in ts_svc.trace_sink.records()]
    assert (ia, ib) == _WARM_TIES
    assert sb["sp1_solver"]["iters_total"] == sum(ib)
    for k in ("rounds", "warm_starts", "warm_resets"):
        assert sb["sp1_solver"][k] == sa["sp1_solver"][k], k
    del sa["sp1_solver"], sb["sp1_solver"]
    assert_summaries_agree(sa, sb)
    np.testing.assert_allclose(ts_svc.state.lam.numpy(),
                               np.asarray(js_svc.state.lam), rtol=1e-5,
                               atol=1e-5)


def test_recycling_and_conservation_with_ring_wrap():
    _, svc = services()
    summary = svc.run(40)
    stats = svc.queue.stats
    assert stats.admitted > svc.cfg.analyst_slots      # rows recycled
    assert summary["grants"] > 0
    assert svc.state.block_birth.min().item() >= 40 - 10
    assert stats.offered == stats.admitted + stats.rejected + \
        svc.queue.depth


def test_occupancy_matches_admission_ledger():
    _, svc = services()
    summary = svc.run(24)
    live = svc.queue.stats.pipelines_admitted - summary["grants"] - \
        summary["expired_pipelines"]
    assert int(svc.table.occupied.sum()) == live


def test_backpressure_rejects_when_queue_full():
    js_svc, ts_svc = services("bursty", analyst_slots=2, admit_batch=2,
                              max_pending=4)
    a, b = js_svc.run(48), ts_svc.run(48)
    assert ts_svc.queue.stats.rejected > 0
    assert 0.0 < b["admission_rate"] < 1.0
    assert_summaries_agree(a, b)


# ---------------------------------------------- expiry and deferred cases
def test_post_wrap_admissions_keep_their_demand():
    """A ring mint must not wipe demand that prefetched admissions just
    wrote for the block being minted (all-mice, depth-1 workload)."""
    kw = dict(seed=11, n_devices=2, pipelines_per_analyst=4,
              p_ten_blocks=0.0)
    jt = js.make_trace("mice_fleet", **kw)
    tt = ts.make_trace("mice_fleet", **kw)
    cfg = dict(scheduler="dpf", analyst_slots=4, pipeline_slots=4,
               block_slots=10 * tt.blocks_per_tick, chunk_ticks=5,
               admit_batch=8, max_pending=64)
    a = js.collect_service_metrics(js.FlaasService(js.ServiceConfig(
        sched=JSched(), **cfg), jt), 30)
    svc = ts.FlaasService(ts.ServiceConfig(sched=TSched(), **cfg), tt,
                          device="cpu")
    b = ts.collect_service_metrics(svc, 30)
    assert float(b["round_efficiency"][12:].sum()) > 0.0
    assert svc.telemetry.expired_pipelines == 0
    assert_ticks_agree(a, b)


def _placements(svc, sub, row, cols, boundary):
    return svc._placement_arrays([(sub, row, cols)], boundary_tick=boundary)


@pytest.mark.parametrize("case", ["retired", "evicted_at_activation"])
def test_deferred_admission_drops_stale_demand(case):
    """A submission deferred across a ring wrap writes no demand for
    blocks evicted while it queued, nor for a block evicted exactly at
    its activation tick -- the same COO triples as repro's."""
    js_svc, ts_svc = services(seed=0, chunk_ticks=4)
    bpr, B = ts_svc.trace.blocks_per_tick, ts_svc.cfg.block_slots
    got = []
    for svc, Sub in ((js_svc, js.Submission), (ts_svc, Submission)):
        if case == "retired":
            svc._ledger_birth[:bpr] = 10
            sub = Sub(analyst=0, submit_tick=0,
                      bids=[np.array([0, 1, B, B + 1], np.int64)],
                      eps=[np.full(4, 0.01, np.float32)],
                      loss=np.array([0.9], np.float32))
            got.append(_placements(svc, sub, 0, [0], 12))
        else:
            svc._ledger_birth[:] = np.arange(B) // bpr
            sub = Sub(analyst=0, submit_tick=5,
                      bids=[np.array([0, 8], np.int64)],
                      eps=[np.full(2, 0.01, np.float32)],
                      loss=np.array([0.9], np.float32))
            got.append(_placements(svc, sub, 0, [0], 10))
    want = [0, 1] if case == "retired" else [8]
    np.testing.assert_array_equal(got[1][6], want)
    for x, y in zip(*got):
        np.testing.assert_array_equal(y, x)


def test_unservable_pipelines_expire_after_ring_wrap():
    js_svc, ts_svc = services(seed=4, trace_kw=dict(
        budget_range=(1e-4, 2e-4)))
    a = js.collect_service_metrics(js_svc, 32)
    b = ts.collect_service_metrics(ts_svc, 32)
    assert_ticks_agree(a, b)
    s = ts_svc.summary()
    assert s["expired_pipelines"] > 0 and s["total_allocated"] == 0
    assert ts_svc.queue.stats.admitted > ts_svc.cfg.analyst_slots
    assert_summaries_agree(js_svc.summary(), s)


# ------------------------------------------------------- host-side pieces
@pytest.mark.parametrize("tick0,n_ticks,shards", [
    (0, 8, 1), (5, 8, 1), (9, 3, 1), (37, 5, 1), (44, 12, 1), (13, 4, 2)])
def test_plan_mints_matches_repro(tick0, n_ticks, shards):
    rng = np.random.default_rng(tick0)
    B, bpd = 80, 2
    dev_budget = rng.uniform(0.5, 1.5, 4)
    prev_budget = rng.uniform(0.5, 1.5, B).astype(np.float32)
    prev_birth = rng.integers(-1, tick0 + 1, B).astype(np.int32)
    a = js.plan_mints(tick0, n_ticks, B, dev_budget, bpd, prev_budget,
                      prev_birth, page_shards=shards)
    b = ts.plan_mints(tick0, n_ticks, B, dev_budget, bpd, prev_budget,
                      prev_birth, page_shards=shards)
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "pages":
            assert (x is None) == (y is None)
            if x is not None:
                for g in ("mint_tick", "hot_slots", "hot_size"):
                    np.testing.assert_array_equal(getattr(y, g),
                                                  getattr(x, g))
        else:
            np.testing.assert_array_equal(y, x, err_msg=f.name)


def test_slot_table_matches_repro():
    """A random admit / release sequence drives both tables to the same
    occupancy, owners, submit ticks and free-row order."""
    rng = np.random.default_rng(0)
    a, b = js.SlotTable(4, 5), ts.SlotTable(4, 5)
    for step in range(200):
        if rng.random() < 0.6:
            analyst, n = int(rng.integers(0, 7)), int(rng.integers(1, 7))
            ra, rb = a.row_for(analyst, n), b.row_for(analyst, n)
            assert ra == rb
            if ra is not None:
                a.commit(analyst, *ra, submit_tick=step)
                b.commit(analyst, *rb, submit_tick=step)
        else:
            done = rng.random((4, 5)) < 0.3
            np.testing.assert_array_equal(b.release_done(done),
                                          a.release_done(done))
        assert a.state_dict().keys() == b.state_dict().keys()
        for k, v in a.state_dict().items():
            np.testing.assert_array_equal(b.state_dict()[k], v, err_msg=k)
        assert a.free_pipeline_slots() == b.free_pipeline_slots()
        assert a.live_rows() == b.live_rows()


def test_admit_batch_matches_repro():
    rng = np.random.default_rng(1)
    M, N, B = 3, 4, 16
    sa = js.ServiceState.create(M, N, B)
    sb = ts.ServiceState.create(M, N, B, device="cpu")
    for _ in range(3):
        mask = rng.random((M, N)) < 0.5
        nnz = int(rng.integers(0, 12))
        rows = rng.integers(0, M, nnz)
        cols = rng.integers(0, N, nnz)
        bids = rng.permutation(B)[:nnz]
        eps = rng.uniform(0.01, 0.2, nnz).astype(np.float32)
        args = (mask, rng.uniform(0.5, 1, (M, N)).astype(np.float32),
                rng.uniform(0, 100, (M, N)).astype(np.float32),
                rng.integers(0, 9, (M, N)).astype(np.int32), rows, cols,
                bids, eps)
        weight = rng.uniform(0.5, 2, M).astype(np.float32)
        sa = js.admit_batch(sa, *args, weight=weight)
        sb = ts.admit_batch(sb, *args, weight=weight)
        for f in dataclasses.fields(sb):
            np.testing.assert_array_equal(getattr(sb, f.name).numpy(),
                                          np.asarray(getattr(sa, f.name)),
                                          err_msg=f.name)


def test_traces_draw_repros_submissions():
    for pattern in ts.PATTERNS:
        jt, tt = traces(pattern, seed=4, tiers="free_pro_enterprise")
        for t in range(30):
            xa, xb = jt.step(t), tt.step(t)
            assert len(xa) == len(xb)
            for p, q in zip(xa, xb):
                assert (p.analyst, p.submit_tick, p.tier, p.priority,
                        p.weight) == (q.analyst, q.submit_tick, q.tier,
                                      q.priority, q.weight)
                np.testing.assert_array_equal(q.loss, p.loss)
                for u, v in zip(p.eps, q.eps):
                    np.testing.assert_array_equal(v, u)


# ---------------------------------------------------------------- tenancy
def test_tenancy_queue_order_and_tier_telemetry_match_repro():
    """free_pro_enterprise: after every chunk the queue holds the same
    submissions in the same drain order (compared by analyst and submit
    tick), the rows the same tenants, and the per-tier telemetry agrees."""
    kw = dict(n_devices=4, pipelines_per_analyst=5,
              tiers="free_pro_enterprise")
    jt = js.make_trace("paper_default", "bursty", seed=2, **kw)
    tt = ts.make_trace("paper_default", "bursty", seed=2, **kw)
    cfg = dict(scheduler="dpbalance", analyst_slots=3, pipeline_slots=5,
               block_slots=10 * tt.blocks_per_tick, chunk_ticks=4,
               admit_batch=2, max_pending=64)
    a = js.FlaasService(js.ServiceConfig(sched=JSched(beta=2.2), **cfg), jt)
    b = ts.FlaasService(ts.ServiceConfig(sched=TSched(beta=2.2), **cfg), tt,
                        device="cpu")
    for _ in range(6):
        assert_ticks_agree(a.run_chunk(), b.run_chunk())
        assert [(s.analyst, s.submit_tick) for s in b.queue.pending] == \
            [(s.analyst, s.submit_tick) for s in a.queue.pending]
        np.testing.assert_array_equal(b.table.row_owner, a.table.row_owner)
        np.testing.assert_array_equal(b._row_weight, a._row_weight)
        np.testing.assert_array_equal(b.state.weight.numpy(),
                                      np.asarray(a.state.weight))
    sa, sb = a.summary(), b.summary()
    assert sb["tenancy"]["tenants"] > 0
    assert_summaries_agree(sa, sb)


# ----------------------------------------------------------- entry points
def test_load_smoke_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.service.load", "--device",
         "cpu", "--smoke"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "device=cpu" in proc.stdout and "OK" in proc.stdout


@pytest.mark.parametrize("scheduler,warm", [("dpbalance", False),
                                             ("dpbalance", True),
                                             ("dpf", False)])
def test_each_tick_calls_every_budget_twin(monkeypatch, scheduler, warm):
    """On the CPU a tick's round calls each budget kernel's twin where the
    card launches the kernel: DPBalance's SP1 ascent, row-max, swap sweep
    once and boost sweep twice a tick; a baseline only the row-max."""
    from repro_torch.kernels import ref
    calls = {}
    for name in ("rowmax_ref", "dual_ascent_ref", "boost_scan_ref",
                 "swap_eval_ref"):
        fn = getattr(ref, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(ref, name, counted)
    _, svc = services("bursty", scheduler=scheduler, chunk_ticks=5,
                      sched_kw=dict(sp1_warm_start=warm))
    svc.run(10)                                 # up to the first wrap
    calls.clear()
    svc.run_chunk()                             # a paged chunk
    assert svc.telemetry.mode_ticks["paged"] == 5
    want = ({"rowmax_ref": 5, "dual_ascent_ref": 5, "boost_scan_ref": 10,
             "swap_eval_ref": 5} if scheduler == "dpbalance"
            else {"rowmax_ref": 5})
    assert calls == want


def test_checkpoint_methods_save_and_load(tmp_path):
    """The checkpoint methods are ported: none raises
    ``NotImplementedError`` any more, and a save then a load into a fresh
    service returns the saved tick (the full contract is
    ``test_torch_service_checkpoint.py``)."""
    from repro_torch.checkpoint import CheckpointManager
    _, svc = services()
    svc.run(8)
    assert svc.checkpoint_host_state()["version"] == 4
    mgr = CheckpointManager(str(tmp_path))
    assert svc.save_checkpoint(mgr) == 8
    _, fresh = services()
    assert fresh.load_checkpoint(mgr) == 8 and fresh.tick == 8


def test_service_package_exports_repros_names():
    import repro.obs as jo
    import repro_torch.obs as to
    assert set(js.__all__) <= set(ts.__all__)
    for name in js.__all__:
        assert hasattr(ts, name), name
    assert set(jo.__all__) <= set(to.__all__)
    for name in jo.__all__:
        assert hasattr(to, name), name
