"""The port stands alone: no JAX, no ``repro``, and no hidden device
fallback.

* Neither ``chip_smoke.py``, the A/B scripts, nor any module under
  ``src/repro_torch/`` imports ``jax`` or ``repro`` (checked on the syntax
  tree, so a lazy import inside a function counts too).
* The input constructors default to CUDA and raise when it is unavailable.
* ``chip_smoke.py`` exits nonzero and prints no verdict without CUDA, and
  outside a checkout of the repository.
* A checkpoint's host payload never imports ``repro``: the loader maps
  ``repro``'s service and observability classes to the port's and refuses
  every other ``repro`` name.
"""
import ast
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core import (Episode, RoundInputs, SchedulerConfig,
                              SimConfig, generate_episode)
from repro_torch.data import batch_iterator
from repro_torch.kernels import build
from repro_torch.launch import fl_e2e, serve
from repro_torch.models import Transformer, init_model, params_from_jax
from repro_torch.service import (FlaasService, ServiceConfig, ServiceState,
                                 load, make_trace, replay_gap)
from repro_torch.training import TrainConfig, make_state

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
# the kernel A/B scripts and the xLSTM gradient probe, run on the card
# beside chip_smoke.py
AB_SCRIPTS = [ROOT / "decode_ab.py", ROOT / "dual_ab.py",
              ROOT / "sweep_ab.py", ROOT / "scan_ab.py",
              ROOT / "flash_ab.py", ROOT / "xlstm_grad_probe.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES + AB_SCRIPTS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_has_every_slice_module():
    have = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
            for p in PORT_FILES[:-1]}
    for mod in ("core/blockaxis.py", "core/demand.py", "core/utility.py",
                "core/hotpath.py", "core/waterfill.py", "core/swap.py",
                "core/packing.py", "core/scheduler.py", "core/simulation.py",
                "core/engine.py", "kernels/ref.py", "kernels/build.py",
                "kernels/budget_alloc.py", "kernels/dp_clip_noise.py",
                "configs/base.py", "configs/flaas_100m.py", "data/blocks.py",
                "data/pipeline.py", "privacy/rdp.py", "privacy/accountant.py",
                "privacy/ledger.py", "models/layers.py",
                "models/transformer.py", "training/dp_sgd.py",
                "training/optimizer.py", "training/train_loop.py",
                "training/fedavg.py", "launch/fl_e2e.py",
                "kernels/flash_attention.py", "kernels/decode_attention.py",
                "models/kv_cache.py", "launch/serve.py",
                "configs/recurrentgemma_2b.py", "kernels/rg_lru.py",
                "models/recurrent.py", "core/baselines.py",
                "core/registry.py", "core/scenarios.py", "launch/sweep.py",
                "service/__init__.py", "service/state.py",
                "service/tenancy.py", "service/traces.py", "service/queue.py",
                "service/telemetry.py", "service/server.py",
                "service/replay.py", "service/load.py", "obs/__init__.py",
                "obs/registry.py", "obs/exporter.py", "obs/audit.py",
                "obs/profiler.py", "obs/tracing.py",
                "checkpoint/__init__.py", "checkpoint/manager.py",
                "shard/__init__.py", "shard/state.py", "shard/service.py",
                "launch/sharded_service.py",
                "configs/llama_3_2_vision_11b.py",
                "configs/whisper_medium.py"):
        assert mod in have, mod
    for cu in ("budget_alloc.cu", "dp_clip_noise.cu", "attention.cu",
               "rg_lru.cu"):
        assert (ROOT / "src/repro_torch/kernels/csrc" / cu).is_file()


@pytest.mark.parametrize("lib", sorted(build.SIGNATURES))
def test_ctypes_signatures_match_the_c_entry_points(lib):
    """Every entry point ``build.SIGNATURES`` declares for a library is
    defined in its source's ``extern "C"`` block with as many parameters
    as ctypes will pass (a wrong count would shift every argument)."""
    src = (build.CSRC / f"{lib}.cu").read_text()
    c_api = src[src.index('extern "C"'):]
    for fn, (args, _) in build.SIGNATURES[lib].items():
        m = re.search(rf"\b{fn}\s*\(([^)]*)\)\s*{{", c_api)
        assert m, (lib, fn)
        params = m.group(1).strip()
        n = 0 if params in ("", "void") else params.count(",") + 1
        assert n == len(args), (lib, fn, n, len(args))


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_input_constructors_default_to_cuda_and_raise_without_it(no_cuda):
    d = dict(demand=np.zeros((1, 1, 2)), active=np.ones((1, 1), bool),
             arrival=np.zeros((1, 1)), loss=np.ones((1, 1)),
             capacity=np.ones(2), budget_total=np.ones(2), now=0.0)
    with pytest.raises(RuntimeError):
        RoundInputs.from_numpy(**d)
    with pytest.raises(RuntimeError):
        Episode.from_numpy(np.zeros((1, 1, 2)), np.ones((1, 1)),
                           np.zeros((1, 1)), np.zeros(1), np.ones(2),
                           np.zeros(2), 1)
    with pytest.raises(RuntimeError):
        generate_episode(SimConfig(n_devices=2, n_analysts=1,
                                   pipelines_per_analyst=1, n_rounds=1))
    # the CPU stays available, but only when asked for
    assert RoundInputs.from_numpy(**d, device="cpu").demand.device.type \
        == "cpu"


def test_fl_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    cfg = reduced(get_arch("flaas-100m"))
    for build in (lambda: fl_e2e.run(rounds=1, small=True),
                  lambda: Transformer(cfg), lambda: init_model(cfg),
                  lambda: params_from_jax({}, cfg),
                  lambda: make_state(0, cfg, TrainConfig(
                      param_dtype="float32")),
                  lambda: batch_iterator(2, 8, cfg.vocab)):
        with pytest.raises(RuntimeError):
            build()
    assert next(batch_iterator(2, 8, cfg.vocab, device="cpu"))[
        "tokens"].device.type == "cpu"


def test_serve_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError):
        serve.run(smoke=True, gen=2, log=None)
    with pytest.raises(RuntimeError):
        serve.main(["--smoke", "--gen", "2"])
    rec = serve.run(smoke=True, gen=2, device="cpu", log=None)
    assert rec["tokens"].shape == (4, 2)


def test_service_defaults_to_cuda_and_raises_without_it(no_cuda):
    trace = make_trace("paper_default", "poisson", seed=2, n_devices=4,
                       pipelines_per_analyst=6)
    cfg = ServiceConfig(analyst_slots=3, pipeline_slots=6, block_slots=80)
    for build in (lambda: FlaasService(cfg, trace),
                  lambda: ServiceState.create(2, 2, 8),
                  lambda: replay_gap(trace, 4, SchedulerConfig(), "dpf"),
                  lambda: load.main(["--smoke"])):
        with pytest.raises(RuntimeError):
            build()
    svc = FlaasService(cfg, trace, device="cpu")
    assert svc.state.demand.device.type == "cpu"
    assert svc.run(2)["ticks"] == 2


def test_sharded_entry_points_default_to_cuda_and_raise_without_it(
        no_cuda):
    """The sharded service and its state default to the card like the
    unsharded ones; the launcher takes --device (and --backend) only
    explicitly."""
    import torch.distributed as dist
    from repro_torch.launch import sharded_service
    from repro_torch.shard import ShardedFlaasService, ShardedServiceState
    trace = make_trace("paper_default", "poisson", seed=2, n_devices=4,
                       pipelines_per_analyst=6)
    cfg = ServiceConfig(analyst_slots=3, pipeline_slots=6, block_slots=80)
    with pytest.raises(RuntimeError):
        sharded_service.rank_device("cuda", 0, 1)
    for argv in (["--shards", "1", "--backend", "gloo"],
                 ["--shards", "1", "--device", "cpu"]):
        with pytest.raises(SystemExit):
            sharded_service.main(argv)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{sharded_service.free_port()}",
        rank=0, world_size=1)
    try:
        for build in (lambda: ShardedFlaasService(cfg, trace),
                      lambda: ShardedServiceState.create(2, 2, 8)):
            with pytest.raises(RuntimeError):
                build()
        svc = ShardedFlaasService(cfg, trace, device="cpu")
        assert svc.state.demand.device.type == "cpu"
        assert svc.run(2)["ticks"] == 2
    finally:
        dist.destroy_process_group()


def test_payload_unpickler_refuses_unmapped_repro_classes(tmp_path):
    """A host payload naming a ``repro`` class outside ``repro.service``
    and ``repro.obs`` is refused before anything is imported; a mapped
    one loads the port's class."""
    import pickle
    from repro_torch.checkpoint.manager import load_host_payload
    bad = tmp_path / "bad.pkl"
    bad.write_bytes(b"crepro.core.scheduler\nSchedulerConfig\n.")
    with pytest.raises(pickle.UnpicklingError, match="repro_torch"):
        load_host_payload(str(bad))
    good = tmp_path / "good.pkl"
    good.write_bytes(b"crepro.service.traces\nSubmission\n.")
    from repro_torch.service.traces import Submission
    assert load_host_payload(str(good)) is Submission


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the smoke run would run for real")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
