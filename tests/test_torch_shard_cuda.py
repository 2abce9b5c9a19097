"""The sharded service on the card (Hopper only; skips elsewhere).

Collects without JAX: the card machine runs these with ``--noconftest``.

* one stripe under NCCL (world size 1) against the unsharded service on
  the card: selections and ``n_allocated`` equal, every metric within
  1e-5.  The unsharded SP1 is ``dual_step``'s one launch and the sharded
  one runs ``matvec`` + ``matvec_t`` a step, which may sum the block axis
  in another order, so the two are not held bitwise;
* two stripes under Gloo with CUDA tensors, both ranks on ``cuda:0``:
  the same checks, and the sharded SP1's kernels launched every tick.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.sharded_service import (service_job, service_jobs,
                                                spawn)

RING, TICKS = 80, 16
METRICS = ("round_efficiency", "round_fairness", "round_fairness_norm",
           "round_jain", "n_allocated", "leftover")


@pytest.fixture
def hopper():
    """Skip unless an sm_90 card is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (compute capability 9.0)")
    return torch.device("cuda")


def job(scheduler):
    # dpbalance with warm SP1: the sharded SP1 is a host loop (two
    # all_reduce calls and a read an iteration), and a cold solve runs
    # hundreds of iterations a tick
    return dict(scheduler=scheduler, ticks=TICKS,
                sched=dict(beta=2.2,
                           sp1_warm_start=scheduler == "dpbalance"),
                service=dict(analyst_slots=3, pipeline_slots=6,
                             block_slots=RING, chunk_ticks=4, admit_batch=8,
                             max_pending=64),
                trace=dict(scenario="paper_default", pattern="bursty",
                           seed=3, n_devices=4, pipelines_per_analyst=6))


def _assert_close_runs(got, want):
    np.testing.assert_array_equal(got["rows"]["selected"],
                                  want["rows"]["selected"])
    np.testing.assert_array_equal(got["rows"]["n_allocated"],
                                  want["rows"]["n_allocated"])
    for k in METRICS:
        np.testing.assert_allclose(got["rows"][k], want["rows"][k],
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert float(got["rows"]["conservation_gap"].max()) <= 1e-4
    assert float(got["rows"]["overdraw"].max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("shards,backend", [(1, "nccl"), (2, "gloo")])
def test_cuda_stripes_match_the_unsharded_card_run(hopper, shards,
                                                   backend):
    names = ("dpbalance", "dpf")
    got = spawn(service_jobs, shards, backend=backend, device="cuda",
                args=([job(n) for n in names],), timeout=600)[0]
    for name, g in zip(names, got):
        want = service_job(0, 1, hopper, job(name), sharded=False)
        _assert_close_runs(g, want)
        assert g["summary"]["sharding"]["n_shards"] == shards
        per_tick = g["launches_per_tick"]
        assert per_tick["rowmax"] == 1.0
        if name == "dpbalance":
            # the sharded SP1 and sweeps: matvec kernels, no fused ascent
            assert per_tick["matvec"] >= 1.0 and per_tick["matvec_t"] >= 2.0
            assert per_tick["dual_step"] == 0.0
            assert per_tick["boost_scan"] == 0.0
            assert per_tick["swap_eval"] == 0.0
