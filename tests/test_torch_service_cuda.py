"""The service plane on the card (Hopper only; skips elsewhere).

Collects without JAX: the card machine runs these with ``--noconftest``.

* one wrapped chunk runs the paged body on the card, bitwise the carry
  body (per-tick outputs and the final state);
* one chunk of a DPBalance service launches each budget kernel the
  expected number of times a tick, and a DPF chunk only ``rowmax``.
"""
import dataclasses

import pytest
import torch

from repro_torch.core import SchedulerConfig
from repro_torch.kernels import budget_alloc as ba
from repro_torch.service import (FlaasService, ServiceConfig,
                                 collect_service_metrics, make_trace)

RING, CHUNK = 80, 5
# budget-kernel launches per tick of each scheduler's round on the card
PER_TICK = {"dpbalance": {"rowmax": 1, "matvec": 1, "matvec_t": 2,
                          "dual_step": 1, "boost_scan": 2, "swap_eval": 1},
            "dpf": {"rowmax": 1}}


@pytest.fixture
def hopper():
    """Skip unless an sm_90 card is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (compute capability 9.0)")
    return torch.device("cuda")


def _service(scheduler, paged, warm=False, ticks=40):
    trace = make_trace("paper_default", "bursty", seed=3, n_devices=4,
                       pipelines_per_analyst=6).precompute(ticks)
    cfg = ServiceConfig(scheduler=scheduler,
                        sched=SchedulerConfig(beta=2.2, sp1_warm_start=warm),
                        analyst_slots=3, pipeline_slots=6, block_slots=RING,
                        chunk_ticks=CHUNK, admit_batch=8, max_pending=64,
                        paged=paged)
    return FlaasService(cfg, trace)


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True])
def test_cuda_paged_chunk_bitwise_carry(hopper, warm):
    """Ticks 0-9 are wrap-free; the chunk at ticks 10-14 re-mints the
    ring's first 40 slots: paged on one service, carry on the other."""
    paged = _service("dpbalance", True, warm)
    plain = _service("dpbalance", False, warm)
    ya = collect_service_metrics(paged, 15)
    yb = collect_service_metrics(plain, 15)
    assert paged.state.demand.is_cuda
    assert paged.telemetry.mode_ticks["paged"] == CHUNK
    assert plain.telemetry.mode_ticks["carry"] == CHUNK
    for k in ya:
        assert (ya[k] == yb[k]).all(), k
    for f in dataclasses.fields(paged.state):
        assert torch.equal(getattr(paged.state, f.name),
                           getattr(plain.state, f.name)), f.name


@pytest.mark.cuda
@pytest.mark.parametrize("scheduler", sorted(PER_TICK))
def test_cuda_kernels_launch_every_tick(hopper, scheduler):
    svc = _service(scheduler, True)
    svc.run(10)                                 # through the first wrap
    ba.reset_launches()
    svc.run_chunk()
    want = {k: CHUNK * PER_TICK[scheduler].get(k, 0) for k in ba.LAUNCHES}
    assert dict(ba.LAUNCHES) == want
