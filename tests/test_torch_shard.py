"""The sharded service plane on the CPU: Gloo process groups of 1, 2 and 4
ranks through ``torch.multiprocessing`` spawn, held to the port's
unsharded service and to ``repro``'s.

Contracts (``repro``'s ``tests/test_shard_service.py`` and
``tests/test_service_checkpoint.py``, at their geometry: 4 devices, 6
pipelines per analyst, an 80-slot ring, 16 ticks):

* ``ring_slots`` / ``remap_ring`` equal ``repro``'s;
* the segmented ``grant_fits_scan`` is bitwise the per-step scan -- and
  the one-device scan over the whole block axis -- on 2 and 4 ranks, with
  fewer collectives than visits;
* one stripe is bitwise the port's ``FlaasService`` (on the CPU both run
  the same twins: ``dual_step_ref`` is ``matvec_ref`` + ``matvec_t_ref``,
  the sharded path's two sweeps);
* 2 and 4 stripes are within 1e-5 of the port's unsharded service and of
  ``repro``'s, selections equal, for all four schedulers, through ring
  wraps on every stripe;
* elastic hand-off 1 -> 4 and 4 -> 1 stripes through a checkpoint within
  1e-5 of the unsharded run, and 4 -> 4 bitwise;
* an indivisible ring and a shard-count conflict are rejected; the
  boundary census agrees with the ledger.

Every spawn runs all of its cases in one process group (the start-up is
paid once) under a time limit, and joins its ranks.  The rank functions
live here and import no JAX: only the parent compares with ``repro``.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import SCHEDULER_NAMES
from repro_torch.core.blockaxis import (COLLECTIVES, LOCAL, grant_fits_scan,
                                        reset_collectives)
from repro_torch.launch.sharded_service import (service_job, service_jobs,
                                                spawn)
from repro_torch.service import summary_fingerprint
from repro_torch.shard import (ShardedFlaasService, all_gather_blocks,
                               block_axis, gather_shard_view, remap_ring,
                               ring_slots)

SIZE = dict(n_devices=4, pipelines_per_analyst=6)
RING, TICKS = 80, 16
HALF, TOTAL = 12, 24
METRICS = ("round_efficiency", "round_fairness", "round_fairness_norm",
           "round_jain", "n_allocated", "leftover")
SPAWN_TIMEOUT = 300.0


def job(scheduler, ticks=TICKS, sched=None, **extra):
    return dict(scheduler=scheduler, ticks=ticks,
                sched=dict(beta=2.2, **(sched or {})),
                service=dict(analyst_slots=3, pipeline_slots=6,
                             block_slots=RING, chunk_ticks=4, admit_batch=8,
                             max_pending=64),
                trace=dict(scenario="paper_default", pattern="poisson",
                           seed=2, **SIZE), **extra)


@functools.lru_cache(maxsize=None)
def unsharded(scheduler, ticks=TICKS, warm=False):
    """The port's FlaasService over the same job (one process, CPU)."""
    return service_job(0, 1, torch.device("cpu"),
                       job(scheduler, ticks,
                           sched=dict(sp1_warm_start=warm)),
                       sharded=False)


@functools.lru_cache(maxsize=None)
def repro_rows(scheduler, ticks=TICKS):
    import repro.service as js
    from repro.core import SchedulerConfig as JSched
    j = job(scheduler, ticks)
    svc = js.FlaasService(
        js.ServiceConfig(scheduler=scheduler, sched=JSched(beta=2.2),
                         **j["service"]),
        js.make_trace("paper_default", "poisson", seed=2, **SIZE))
    return js.collect_service_metrics(svc, ticks)


def max_gap(ya, yb, keys=METRICS):
    """Scale-normalised max gap (``replay_gap``'s convention)."""
    worst = 0.0
    for k in keys:
        a = np.asarray(ya[k], np.float64)
        b = np.asarray(yb[k], np.float64)
        worst = max(worst, float(np.max(np.abs(a - b)) /
                                 max(1.0, np.max(np.abs(a)))))
    return worst


def fingerprint(summary):
    return json.dumps(summary_fingerprint(summary), sort_keys=True)


# ------------------------------------------------------------ rank side
FITS_CASES = ((0, 8), (1, 3), (2, 8), (3, 1))     # (seed, segment)


def _fits_inputs(seed):
    """[3, 21, 24] visits against budgets that refuse about half."""
    rng = np.random.default_rng(seed)
    M, V, K = 3, 21, 24
    dems = (rng.random((M, V, K)) * 0.25).astype(np.float32) * \
        (rng.random((M, V, K)) < 0.3)
    act = rng.random((M, V)) < 0.8
    rem = (0.2 + rng.random((M, K)) * 0.8).astype(np.float32)
    return dems, act, rem


def _fits_cases(world):
    """Segmented grant_fits_scan on this rank's stripe of the K = 24
    blocks; the remaining capacity gathered back to the whole axis."""
    out = []
    for seed, G in FITS_CASES:
        dems, act, rem = _fits_inputs(seed)
        per = dems.shape[-1] // world
        r = _rank()
        st = slice(r * per, (r + 1) * per)
        reset_collectives()
        left, taken = grant_fits_scan(
            torch.from_numpy(dems[..., st].copy()), torch.from_numpy(act),
            torch.from_numpy(rem[..., st].copy()), 1e-6,
            block_axis(fits_segment=G))
        n_coll = COLLECTIVES["all_reduce"]
        out.append((seed, G, all_gather_blocks(left).numpy(),
                    taken.numpy(), n_coll))
    return out


def _rank():
    import torch.distributed as dist
    return dist.get_rank()


def rank_cases(rank, world, device, plan):
    """Every case of one spawn, in order; rank 0 returns the results."""
    out = {}
    if "fits" in plan:
        out["fits"] = _fits_cases(world)
    if "parity" in plan:
        out["parity"] = service_jobs(rank, world, device,
                                     [job(s) for s in SCHEDULER_NAMES])
    if "reject" in plan:
        from repro_torch.launch.sharded_service import make_service
        errs = {}
        try:
            make_service(dict(job("dpf"), service=dict(
                job("dpf")["service"], block_slots=RING + 1)), device)
        except ValueError as e:
            errs["indivisible"] = str(e)
        try:
            ShardedFlaasService(*_cfg_trace(), n_shards=world + 1,
                                device=device)
        except ValueError as e:
            errs["conflict"] = str(e)
        out["reject"] = errs
    if "census" in plan:
        from repro_torch.launch.sharded_service import make_service
        svc = make_service(job("dpf"), device)
        svc.run(12)
        live, free = gather_shard_view(svc)
        whole = svc.sharded.gather()
        out["census"] = (live, free, whole.block_capacity.numpy(),
                         whole.block_birth.numpy(), svc.summary(),
                         int(svc.table.occupied.sum()))
    if "replay" in plan:
        from repro_torch.core import SchedulerConfig
        from repro_torch.service import make_trace, replay_gap
        out["replay"] = replay_gap(
            make_trace("paper_default", "poisson", seed=2, **SIZE), 10,
            SchedulerConfig(beta=2.2), "dpf", chunk_ticks=5,
            service_factory=ShardedFlaasService, block_slots_multiple=world,
            device=device)
    if "elastic" in plan:
        e = plan["elastic"]
        out["elastic"] = service_jobs(rank, world, device, [
            # 1 -> S: restore the parent's one-stripe checkpoint
            job("dpbalance", TOTAL, sched=dict(sp1_warm_start=True),
                restore=e["one"]),
            # S -> 1: run half, checkpoint for the parent to restore
            job("dpbalance", HALF, sched=dict(sp1_warm_start=True),
                save=e["wide"]),
            # S -> S: uninterrupted, then crash at HALF and resume
            job("dpf", TOTAL),
            job("dpf", HALF, save=e["same"], async_save=True),
            job("dpf", TOTAL, restore=e["same"])])
    return out if rank == 0 else None


def _cfg_trace():
    from repro_torch.core import SchedulerConfig
    from repro_torch.service import ServiceConfig, make_trace
    j = job("dpf")
    return (ServiceConfig(scheduler="dpf", sched=SchedulerConfig(),
                          **j["service"]),
            make_trace("paper_default", "poisson", seed=2, **SIZE))


def _spawn(world, plan):
    return spawn(rank_cases, world, backend="gloo", device="cpu",
                 args=(plan,), timeout=SPAWN_TIMEOUT)[0]


@pytest.fixture(scope="module")
def one_rank():
    return _spawn(1, {"parity": 1, "reject": 1})


@pytest.fixture(scope="module")
def two_ranks():
    return _spawn(2, {"fits": 1, "parity": 1, "reject": 1, "census": 1,
                      "replay": 1})


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    e = {k: str(d / k) for k in ("one", "wide", "same")}
    # the one-stripe checkpoint the 4-rank service starts from
    service_job(0, 1, torch.device("cpu"),
                job("dpbalance", HALF, sched=dict(sp1_warm_start=True),
                    save=e["one"]), sharded=False)
    out = _spawn(4, {"fits": 1, "parity": 1, "elastic": e})
    out["dirs"] = e
    return out


# ---------------------------------------------------------------- layout
class TestStripedRing:
    @pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
    def test_ring_slots_equal_repros(self, n_shards):
        from repro.shard import ring_slots as jring
        bids = np.arange(5 * RING)
        np.testing.assert_array_equal(ring_slots(bids, n_shards, RING),
                                      jring(bids, n_shards, RING))

    @pytest.mark.parametrize("s_from", [1, 2, 4])
    @pytest.mark.parametrize("s_to", [1, 2, 4])
    def test_remap_ring_equals_repros(self, s_from, s_to):
        from repro.shard import remap_ring as jremap
        idx = remap_ring(s_from, s_to, RING)
        np.testing.assert_array_equal(idx, jremap(s_from, s_to, RING))
        for bid in range(3 * RING):
            assert idx[ring_slots(bid, s_to, RING)] == \
                ring_slots(bid, s_from, RING)

    def test_one_shard_degenerates_to_modulo(self):
        bids = np.arange(1000)
        np.testing.assert_array_equal(ring_slots(bids, 1, RING), bids % RING)

    @pytest.mark.parametrize("n_shards", [2, 4])
    def test_mints_are_stripe_local(self, n_shards):
        per = RING // n_shards
        bids = np.arange(5 * RING)
        assert (ring_slots(bids, n_shards, RING) // per ==
                bids % n_shards).all()

    def test_remap_rejects_indivisible(self):
        for a, b in ((1, 3), (3, 1), (0, 1)):
            with pytest.raises(ValueError):
                remap_ring(a, b, RING)


# ------------------------------------------------------- grant_fits_scan
@pytest.mark.parametrize("ranks", ["two_ranks", "four_ranks"])
def test_segmented_grant_fits_is_bitwise_the_scan(ranks, request):
    """Every rank's stripe through the segmented sweep: the gathered
    remaining capacity and the decisions equal the one-device scan over
    the whole block axis, bit for bit, for segments of 8, 3 and 1."""
    res = request.getfixturevalue(ranks)["fits"]
    assert [r[:2] for r in res] == list(FITS_CASES)
    for seed, G, left, taken, n_coll in res:
        dems, act, rem = _fits_inputs(seed)
        V = act.shape[-1]
        want_left, want_taken = grant_fits_scan(
            torch.from_numpy(dems), torch.from_numpy(act),
            torch.from_numpy(rem), 1e-6, LOCAL)
        np.testing.assert_array_equal(taken, want_taken.numpy())
        assert torch.equal(torch.from_numpy(left), want_left), (seed, G)
        assert 0 < want_taken.sum() < act.sum()     # some refusals
        if G == 1:
            assert n_coll == V                      # one per visit
        else:
            assert n_coll < V                       # batched per segment


# -------------------------------------------------------------- parity
def _rows_equal(a, b):
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                      err_msg=k)


def test_one_stripe_is_bitwise_the_unsharded_service(one_rank):
    for name, got in zip(SCHEDULER_NAMES, one_rank["parity"]):
        want = unsharded(name)
        assert sorted(got["rows"]) == sorted(want["rows"])
        _rows_equal(want["rows"], got["rows"])
        for k in want["state"]:
            np.testing.assert_array_equal(got["state"][k], want["state"][k],
                                          err_msg=(name, k))
        s = dict(got["summary"])
        assert s.pop("sharding")["n_shards"] == 1
        assert fingerprint(s) == fingerprint(want["summary"]), name


@pytest.mark.parametrize("ranks", ["two_ranks", "four_ranks"])
@pytest.mark.parametrize("scheduler", SCHEDULER_NAMES)
def test_stripes_match_the_port_and_repro(ranks, scheduler, request):
    """2 and 4 stripes: selections equal the unsharded port's, every
    metric within 1e-5 of it and of repro's; the ring wrapped on every
    stripe (16 ticks x 8 blocks through 80 slots)."""
    got = request.getfixturevalue(ranks)["parity"][
        SCHEDULER_NAMES.index(scheduler)]
    want = unsharded(scheduler)
    np.testing.assert_array_equal(got["rows"]["selected"],
                                  want["rows"]["selected"])
    np.testing.assert_array_equal(got["rows"]["n_allocated"],
                                  want["rows"]["n_allocated"])
    assert max_gap(want["rows"], got["rows"]) <= 1e-5
    ref = repro_rows(scheduler)
    np.testing.assert_array_equal(got["rows"]["n_allocated"],
                                  np.asarray(ref["n_allocated"]))
    assert max_gap(ref, got["rows"]) <= 1e-5
    assert int(got["state"]["block_birth"].min()) >= TICKS - 10
    assert float(got["rows"]["conservation_gap"].max()) <= 1e-4
    assert float(got["rows"]["overdraw"].max()) <= 1e-4
    n = 2 if ranks == "two_ranks" else 4
    assert got["summary"]["sharding"]["n_shards"] == n
    assert got["collectives_per_tick"]["all_reduce"] > 0


def test_replay_oracle_through_two_stripes(two_ranks):
    gaps = two_ranks["replay"]
    assert max(gaps.values()) <= 1e-5, gaps


def test_census_matches_the_ledger(two_ranks):
    live, free, cap, birth, summary, occupied = two_ranks["census"]
    assert live.shape == (2,)
    assert int(live.sum()) == int(((birth >= 0) & (cap > 0.0)).sum())
    assert int(live.max()) <= RING // 2
    assert free == 3 * 6 - occupied
    s = summary["sharding"]
    assert s["n_shards"] == 2 and s["blocks_per_shard"] == RING // 2
    # the summary holds the census of the last boundary, before its chunk
    assert len(s["shard_live_blocks"]) == 2
    assert 0 < min(s["shard_live_blocks"]) <= RING // 2


@pytest.mark.parametrize("ranks", ["one_rank", "two_ranks"])
def test_rejections(ranks, request):
    errs = request.getfixturevalue(ranks)["reject"]
    assert "n_shards" in errs["conflict"]
    if ranks == "two_ranks":
        assert "not divisible" in errs["indivisible"]


# -------------------------------------------------------------- elastic
def test_elastic_one_to_four(four_ranks):
    want = unsharded("dpbalance", TOTAL, warm=True)
    first = unsharded("dpbalance", HALF, warm=True)
    got = four_ranks["elastic"][0]
    rows = {k: np.concatenate([first["rows"][k], got["rows"][k]])
            for k in METRICS}
    assert max_gap(want["rows"], rows) <= 1e-5
    np.testing.assert_array_equal(
        np.concatenate([first["rows"]["selected"],
                        got["rows"]["selected"]]), want["rows"]["selected"])


def test_elastic_four_to_one(four_ranks):
    from repro_torch.launch.sharded_service import make_service
    want = unsharded("dpbalance", TOTAL, warm=True)
    head = four_ranks["elastic"][1]
    back = service_job(0, 1, torch.device("cpu"),
                       job("dpbalance", TOTAL,
                           sched=dict(sp1_warm_start=True),
                           restore=four_ranks["dirs"]["wide"]),
                       sharded=False)
    rows = {k: np.concatenate([head["rows"][k], back["rows"][k]])
            for k in METRICS}
    assert max_gap(want["rows"], rows) <= 1e-5
    probe = make_service(job("dpf"), torch.device("cpu"), sharded=False)
    _, host, _ = CheckpointManager(four_ranks["dirs"]["wide"]).restore(
        probe.state, with_host=True)
    assert host["layout_shards"] == 4


def test_elastic_four_to_four_is_bitwise(four_ranks):
    ref, _, resumed = four_ranks["elastic"][2:]
    for k in ref["rows"]:
        np.testing.assert_array_equal(resumed["rows"][k],
                                      ref["rows"][k][HALF:], err_msg=k)
    for k in ref["state"]:
        np.testing.assert_array_equal(resumed["state"][k], ref["state"][k],
                                      err_msg=k)
    assert fingerprint(ref["summary"]) == fingerprint(resumed["summary"])


def test_sharded_state_layout():
    """ShardedServiceState keeps the rank's stripe of every block-axis
    field and replicates the tables (one rank here: the whole ring)."""
    import torch.distributed as dist
    from repro_torch.service.state import BLOCK_FIELDS, ServiceState
    from repro_torch.shard import ShardedServiceState
    from repro_torch.launch.sharded_service import free_port
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        st = ShardedServiceState.create(2, 4, RING, device="cpu")
        assert st.n_shards == 1 and st.blocks_per_shard == RING
        assert st.stripe == slice(0, RING)
        whole = st.gather()
        ref = ServiceState.create(2, 4, RING, device="cpu")
        for f in dataclasses.fields(ref):
            assert torch.equal(getattr(whole, f.name), getattr(ref, f.name))
        assert set(BLOCK_FIELDS) < {f.name for f in dataclasses.fields(ref)}
    finally:
        dist.destroy_process_group()
