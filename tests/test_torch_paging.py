"""The port's paged two-ring demand residency through the wrapped regime.

``test_paging.py``'s stress geometry (M=3 analysts x N=6 pipelines, an
80-slot ring at 8 blocks a tick, 90 ticks = 8 ring wraps, chunks of 5,
continuously bursty arrivals), on the CPU:

* the port's paged service against ``repro``'s paged service, per tick,
  for all four schedulers: selections, ``n_allocated`` and ``expired``
  equal, continuous outputs within rtol 1e-5 / atol 1e-5;
* the port's paged service against the port's full-tensor carry
  (``paged=False``), bitwise: per-tick outputs and every field of the
  final ``ServiceState``;
* the spill fallback (a chunk that mints one slot twice) and an uneven
  last chunk, both bitwise;
* the certified swap beam on against off, bitwise (``repro``'s own
  beam-on service is not bitwise with its beam-off run, so the beam is
  held to the port's full sweep).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.service as js
from repro.core import SchedulerConfig as JSched
from repro_torch import service as ts
from repro_torch.core import SCHEDULER_NAMES
from repro_torch.core import SchedulerConfig as TSched

SIZE = dict(n_devices=4, pipelines_per_analyst=6)
RING, WRAP_TICKS, CHUNK = 80, 90, 5
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


def stress_traces(ticks=WRAP_TICKS, seed=3):
    return (js.make_trace("paper_default", "bursty", seed=seed,
                          **SIZE).precompute(ticks),
            ts.make_trace("paper_default", "bursty", seed=seed,
                          **SIZE).precompute(ticks))


def config(mod, sched, scheduler, paged, chunk=CHUNK, **over):
    sched_kw = over.pop("sched_kw", {})
    return mod.ServiceConfig(scheduler=scheduler,
                             sched=sched(beta=2.2, **sched_kw),
                             analyst_slots=3, pipeline_slots=6,
                             block_slots=RING, chunk_ticks=chunk,
                             admit_batch=8, max_pending=64, paged=paged,
                             **over)


def port(trace, scheduler, paged, **kw):
    return ts.FlaasService(config(ts, TSched, scheduler, paged, **kw),
                           trace.reset(), device="cpu")


def reference(trace, scheduler, **kw):
    return js.FlaasService(config(js, JSched, scheduler, True, **kw),
                           trace.reset())


def assert_bitwise(ya, yb):
    assert sorted(ya) == sorted(yb)
    for k in ya:
        np.testing.assert_array_equal(np.asarray(ya[k]), np.asarray(yb[k]),
                                      err_msg=f"{k!r} differs")


def assert_states_bitwise(a, b):
    for f in dataclasses.fields(a.state):
        assert torch.equal(getattr(a.state, f.name),
                           getattr(b.state, f.name)), f.name


def assert_matches_repro(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        x, y = np.asarray(want[k]), np.asarray(got[k])
        if k in DISCRETE or x.dtype.kind in "bi":
            np.testing.assert_array_equal(y, x, err_msg=k)
        else:
            np.testing.assert_allclose(y.astype(np.float64),
                                       x.astype(np.float64), rtol=1e-5,
                                       atol=1e-5, err_msg=k)


@pytest.mark.parametrize("scheduler", SCHEDULER_NAMES)
def test_eight_wraps_match_repro_and_carry(scheduler):
    jt, tt = stress_traces()
    ref = reference(jt, scheduler)
    paged = port(tt, scheduler, paged=True)
    plain = port(tt, scheduler, paged=False)
    yr = js.collect_service_metrics(ref, WRAP_TICKS)
    ya = ts.collect_service_metrics(paged, WRAP_TICKS)
    yp = ts.collect_service_metrics(plain, WRAP_TICKS)
    assert_matches_repro(ya, yr)
    assert_bitwise(ya, yp)
    assert_states_bitwise(paged, plain)
    modes = paged.summary()["paging"]["mode_ticks"]
    assert modes["paged"] >= 8 * RING // tt.blocks_per_tick
    assert modes["carry"] == 0
    assert plain.summary()["paging"]["mode_ticks"]["paged"] == 0
    assert paged.summary()["paging"] == ref.summary()["paging"]
    np.testing.assert_array_equal(paged.state.demand.numpy(),
                                  np.asarray(ref.state.demand))


def test_warm_sp1_paged_matches_carry_and_repro():
    """The warm SP1 dual joins the carry; minted slots reset to 1.0.
    Paged against carry stays bitwise, lam included."""
    jt, tt = stress_traces()
    kw = dict(sched_kw=dict(sp1_warm_start=True))
    ref = reference(jt, "dpbalance", **kw)
    paged = port(tt, "dpbalance", paged=True, **kw)
    plain = port(tt, "dpbalance", paged=False, **kw)
    ya = ts.collect_service_metrics(paged, WRAP_TICKS)
    assert_bitwise(ya, ts.collect_service_metrics(plain, WRAP_TICKS))
    assert_states_bitwise(paged, plain)
    assert_matches_repro(ya, js.collect_service_metrics(ref, WRAP_TICKS))
    np.testing.assert_allclose(paged.state.lam.numpy(),
                               np.asarray(ref.state.lam), rtol=1e-5,
                               atol=1e-5)


def test_spill_falls_back_to_carry_bitwise():
    # a 12-tick chunk mints 96 bids into the 80-slot ring: one slot is
    # re-minted twice inside the chunk, so the paged service drops to the
    # full-tensor carry -- exactly.
    jt, tt = stress_traces(48)
    paged = port(tt, "dpf", paged=True, chunk=12)
    plain = port(tt, "dpf", paged=False, chunk=12)
    ya = ts.collect_service_metrics(paged, 48)
    assert_bitwise(ya, ts.collect_service_metrics(plain, 48))
    assert_states_bitwise(paged, plain)
    assert_matches_repro(ya, js.collect_service_metrics(
        reference(jt, "dpf", chunk=12), 48))
    modes = paged.summary()["paging"]["mode_ticks"]
    assert modes["paged"] == 0 and modes["carry"] > 0


def test_uneven_last_chunk_stays_paged_and_bitwise():
    jt, tt = stress_traces()
    paged = port(tt, "fcfs", paged=True, chunk=7)
    plain = port(tt, "fcfs", paged=False, chunk=7)
    ya = ts.collect_service_metrics(paged, 47)
    assert_bitwise(ya, ts.collect_service_metrics(plain, 47))
    assert_states_bitwise(paged, plain)
    assert_matches_repro(ya, js.collect_service_metrics(
        reference(jt, "fcfs", chunk=7), 47))


def test_beam_on_is_bitwise_beam_off():
    """swap_beam=8 through 8 wraps: every tick certifies or falls back to
    the full sweep, so the schedule is the full sweep's bit for bit."""
    _, tt = stress_traces()
    off = port(tt, "dpbalance", paged=True)
    on = port(tt, "dpbalance", paged=True, sched_kw=dict(swap_beam=8))
    y_off = ts.collect_service_metrics(off, WRAP_TICKS)
    y_on = ts.collect_service_metrics(on, WRAP_TICKS)
    assert_bitwise(y_on, y_off)
    assert_states_bitwise(on, off)
    pruning = on.summary()["swap_pruning"]
    assert pruning["rounds"] == WRAP_TICKS


def test_paging_counters_match_repro():
    jt, tt = stress_traces()
    ref, svc = reference(jt, "dpf"), port(tt, "dpf", paged=True)
    ref.run(WRAP_TICKS)
    svc.run(WRAP_TICKS)
    paging = svc.summary()["paging"]
    assert sum(paging["mode_ticks"].values()) == WRAP_TICKS
    n_paged_chunks = paging["mode_ticks"]["paged"] // CHUNK
    assert paging["pages_swept"] == \
        n_paged_chunks * CHUNK * tt.blocks_per_tick
    assert paging["slots_evicted"] > 0
    assert paging == ref.summary()["paging"]
    assert svc.telemetry.expired_pipelines == \
        ref.telemetry.expired_pipelines
    assert svc.telemetry.grants == ref.telemetry.grants


@pytest.mark.parametrize("tick0,n_ticks,bpr,shards", [
    (20, 4, 8, 1), (10, 10, 8, 1), (10, 11, 8, 1), (13, 4, 8, 2),
    (13, 4, 8, 4), (0, 1, 6, 4)])
def test_plan_pages_matches_repro(tick0, n_ticks, bpr, shards):
    a = js.plan_pages(tick0, n_ticks, RING, bpr, None, shards)
    b = ts.plan_pages(tick0, n_ticks, RING, bpr, None, shards)
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(b.mint_tick, a.mint_tick)
        np.testing.assert_array_equal(b.hot_slots, a.hot_slots)
        assert b.hot_size == a.hot_size
        assert (b.mint_tick != ts.NEVER).sum() == b.hot_size
