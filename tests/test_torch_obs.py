"""The port's observability plane against ``repro``'s on the CPU.

* ``trace_level=0`` with no audit is bitwise-neutral: a service with the
  plane on (``trace_level=2`` + an audit ledger) gives the same per-tick
  outputs and final state bit for bit, paged and carry, every scheduler;
* the level-1 and level-2 decision traces agree with ``repro``'s (counts
  equal, continuous values within rtol 1e-5 / atol 1e-5);
* the audit ledger verifies with the port's own ``verify_ledger`` and
  records ``repro``'s grants;
* the Prometheus exposition of one registry equals ``repro``'s text, and
  the JSON-lines sink round-trips;
* the telemetry reservoir resumed from its state dict equals an
  uninterrupted run.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.obs as jo
import repro.service as js
from repro.core import SchedulerConfig as JSched
from repro.service.telemetry import _Reservoir as JReservoir
from repro_torch import obs as to
from repro_torch import service as ts
from repro_torch.core import SCHEDULER_NAMES
from repro_torch.core import SchedulerConfig as TSched
from repro_torch.obs.audit import _main as audit_main
from repro_torch.service.telemetry import _Reservoir

# test_obs.py's geometry: 8 blocks/tick into an 80-slot ring, 40 ticks =
# 4 ring wraps
SIZE = dict(n_devices=4, pipelines_per_analyst=6)
RING, TICKS, CHUNK = 80, 40, 5


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


def trace_pair(pattern="bursty", seed=3, ticks=TICKS):
    return (js.make_trace("paper_default", pattern, seed=seed,
                          **SIZE).precompute(ticks),
            ts.make_trace("paper_default", pattern, seed=seed,
                          **SIZE).precompute(ticks))


def cfg_kw(scheduler, paged=True, **over):
    return dict(scheduler=scheduler, analyst_slots=3, pipeline_slots=6,
                block_slots=RING, chunk_ticks=CHUNK, admit_batch=8,
                max_pending=64, paged=paged, **over)


def port(trace, scheduler="dpbalance", paged=True, **over):
    return ts.FlaasService(ts.ServiceConfig(
        sched=TSched(beta=2.2), **cfg_kw(scheduler, paged, **over)),
        trace.reset(), device="cpu")


def reference(trace, scheduler="dpbalance", **over):
    return js.FlaasService(js.ServiceConfig(
        sched=JSched(beta=2.2), **cfg_kw(scheduler, **over)), trace.reset())


def close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype.kind in "bi":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), rtol=1e-5,
                                   atol=1e-5, err_msg=what)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "carry"])
@pytest.mark.parametrize("scheduler", SCHEDULER_NAMES)
def test_obs_off_is_bitwise_neutral(scheduler, paged, tmp_path):
    _, tt = trace_pair()
    off = port(tt, scheduler, paged)
    on = port(tt, scheduler, paged, trace_level=2,
              audit_path=str(tmp_path / "ledger.jsonl"))
    y_off = ts.collect_service_metrics(off, TICKS)
    y_on = ts.collect_service_metrics(on, TICKS)
    assert sorted(y_off) == sorted(y_on)
    for k in y_off:
        np.testing.assert_array_equal(y_on[k], y_off[k], err_msg=k)
    for f in dataclasses.fields(off.state):
        assert torch.equal(getattr(on.state, f.name),
                           getattr(off.state, f.name)), f.name
    assert len(on.trace_sink) == TICKS and off.trace_sink is None
    on.close()
    assert to.verify_ledger(str(tmp_path / "ledger.jsonl"))["ok"]


@pytest.mark.parametrize("level,scheduler", [(1, "dpf"), (2, "dpbalance"),
                                             (2, "fcfs")])
def test_decision_traces_match_repro(level, scheduler):
    jt, tt = trace_pair()
    a = reference(jt, scheduler, trace_level=level)
    b = port(tt, scheduler, trace_level=level)
    a.run(TICKS)
    b.run(TICKS)
    ra, rb = a.trace_sink.records(), b.trace_sink.records()
    assert len(rb) == TICKS and [r["tick"] for r in rb] == list(range(TICKS))
    assert set(rb[0]) == {"tick"} | {k[len(to.TRACE_KEY_PREFIX):]
                                     for k in to.trace_ys_keys(level)}
    for x, y in zip(ra, rb):
        assert sorted(x) == sorted(y)
        for k in x:
            close(y[k], x[k], f"tick {x['tick']} {k}")
    if scheduler == "dpbalance":
        assert max(r["sp1_iters"] for r in rb) > 0
    else:
        assert all(r["sp1_iters"] == 0 for r in rb)
    doc = b.trace_sink.to_chrome_trace()
    assert len(doc["traceEvents"]) == TICKS * len(to.trace_ys_keys(level))
    assert {e["ph"] for e in doc["traceEvents"]} == {"C"}


def test_trace_ring_is_bounded():
    _, tt = trace_pair()
    svc = port(tt, "dpf", trace_level=1, trace_ticks=8)
    svc.run(TICKS)
    recs = svc.trace_sink.records()
    assert [r["tick"] for r in recs] == list(range(TICKS - 8, TICKS))
    assert "sp2_objective" not in recs[0]


def test_audit_ledger_verifies_and_matches_repro(tmp_path):
    """Steady poisson load through 4 wraps: the port's ledger verifies
    (chain and per-block conservation) and records repro's grants."""
    jt, tt = trace_pair("poisson", seed=2)
    pa, pb = str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")
    a = reference(jt, audit_path=pa)
    b = port(tt, audit_path=pb)
    a.run(TICKS)
    b.run(TICKS)
    a.close()
    b.close()
    report = to.verify_ledger(pb)
    assert report["ok"], report["violations"]
    assert report["grants"] > 0 and report["opens"] == 1
    assert 0 < report["max_block_utilization"] <= 1.0 + 1e-5
    ga = [r for r in jo.read_ledger(pa) if r["kind"] == "grant"]
    gb = [r for r in to.read_ledger(pb) if r["kind"] == "grant"]
    assert len({b // RING for r in gb for b in r["bids"]}) >= 2
    assert [(r["tick"], r["analyst"], r["pipeline"], r["tier"], r["bids"])
            for r in gb] == [(r["tick"], r["analyst"], r["pipeline"],
                              r["tier"], r["bids"]) for r in ga]
    for x, y in zip(ga, gb):
        close(y["eps"], x["eps"], "eps")
        close(y["x"], x["x"], "x")
    ref_report = jo.verify_ledger(pa)
    for k in ("grants", "opens", "blocks"):
        if k in ref_report:
            assert report[k] == ref_report[k], k
    # the port's verifier accepts repro's ledger, and the other way round
    assert to.verify_ledger(pa)["ok"] and jo.verify_ledger(pb)["ok"]


def test_audit_tamper_and_cli(tmp_path, capsys):
    _, tt = trace_pair("poisson", seed=2, ticks=2 * CHUNK)
    path = str(tmp_path / "ledger.jsonl")
    svc = port(tt, audit_path=path)
    svc.run(2 * CHUNK)
    svc.close()
    assert audit_main(["verify", path]) == 0
    assert json.loads(capsys.readouterr().out)["ok"]
    lines = open(path).read().splitlines()
    i = next(i for i, l in enumerate(lines) if '"kind":"grant"' in l)
    rec = json.loads(lines[i])
    rec["x"] *= 0.5
    lines[i] = json.dumps(rec, sort_keys=True, separators=(",", ":"))
    open(path, "w").write("\n".join(lines) + "\n")
    assert not to.verify_ledger(path)["ok"]
    assert audit_main(["verify", path]) == 1


def _fill(reg_mod):
    reg = reg_mod.MetricsRegistry()
    reg.counter("flaas_ticks_total", "Service ticks executed").set_total(40)
    adm = reg.counter("flaas_admission_total",
                      "Admission pipeline outcomes", ("outcome",))
    adm.set_total(12, ("admitted",))
    adm.set_total(3, ("rejected",))
    reg.gauge("flaas_jain_index_mean", "Mean per-tick Jain index").set(0.875)
    reg.gauge("g", "").set(float("inf"))
    h = reg.histogram("flaas_chunk_seconds", "Wall seconds per chunk",
                      buckets=(0.1, 1.0))
    h.observe_many(np.array([0.25, 0.5, 2.0, 0.25]))
    return reg


def test_prometheus_text_equals_repros():
    assert to.render_prometheus(_fill(to)) == jo.render_prometheus(_fill(jo))
    # one service summary (repro's) absorbed by both registries
    jt, _ = trace_pair()
    svc = reference(jt, "dpf")
    svc.run(2 * CHUNK)
    ra, rb = jo.MetricsRegistry(), to.MetricsRegistry()
    jo.absorb_summary(ra, svc.summary())
    to.absorb_summary(rb, svc.summary())
    assert to.render_prometheus(rb) == jo.render_prometheus(ra)
    clone = to.MetricsRegistry()
    clone.load_state_dict(rb.state_dict())
    assert to.render_prometheus(clone) == to.render_prometheus(rb)


def test_service_publishes_live_metrics():
    """The exporter endpoint (loopback, ephemeral port) serves the
    service's catalog, phase timers included."""
    import urllib.request
    _, tt = trace_pair()
    svc = port(tt, "dpf", metrics_port=0, profile_annotations=True)
    try:
        svc.run(2 * CHUNK)
        with urllib.request.urlopen(svc.metrics_server.url,
                                    timeout=5) as resp:
            text = resp.read().decode()
        assert f"flaas_ticks_total {2 * CHUNK}" in text
        assert 'flaas_phase_seconds_total{phase="chunk_execute"}' in text
        phases = svc.profiler.summary()
        for name in ("admit_drain", "plan_mints", "chunk_execute",
                     "host_sync", "telemetry_fold"):
            assert phases[name]["calls"] == 2, name
    finally:
        svc.close()


def test_jsonl_sink_round_trips(tmp_path):
    path = tmp_path / "t.jsonl"
    path.write_text('{"tick": 0}\n')
    with to.JsonlSink(str(path)) as sink:
        sink.write({"tick": 1, "x": np.float32(0.5), "nan": float("nan"),
                    "arr": np.arange(3)})
    lines = [json.loads(l) for l in path.read_text().splitlines()]
    assert [l["tick"] for l in lines] == [0, 1]
    assert lines[1]["x"] == 0.5 and lines[1]["nan"] is None
    assert lines[1]["arr"] == [0, 1, 2]
    sink.close()
    with pytest.raises(ValueError):
        sink.write({"tick": 2})
    # a service on the same path appends one summary per chunk
    _, tt = trace_pair()
    for _ in range(2):
        svc = port(tt, "dpf", telemetry_path=str(path))
        svc.run(2 * CHUNK)
        svc.close()
    recs = [json.loads(l) for l in path.read_text().splitlines()]
    assert len(recs) == 2 + 4
    assert all("ticks" in r for r in recs[2:])


def test_reservoir_resume_equals_uninterrupted_run():
    vals = np.random.default_rng(1).normal(size=500)
    whole = _Reservoir(32, seed=3)
    whole.add(vals)
    ref = JReservoir(32, seed=3)
    ref.add(vals)
    np.testing.assert_array_equal(whole.buf, ref.buf)
    first = _Reservoir(32, seed=3)
    first.add(vals[:250])
    resumed = _Reservoir(32, seed=999)          # seed overwritten by load
    resumed.load_state_dict(first.state_dict())
    resumed.add(vals[250:])
    np.testing.assert_array_equal(resumed.buf, whole.buf)
    assert resumed.n_seen == whole.n_seen == 500
