"""The port stands alone: no JAX, no ``repro``, and no hidden device
fallback.

* Neither ``chip_smoke.py`` nor any module under ``src/repro_torch/``
  imports ``jax`` or ``repro`` (checked on the syntax tree, so a lazy
  import inside a function counts too).
* The input constructors default to CUDA and raise when it is unavailable.
* ``chip_smoke.py`` exits nonzero and prints no verdict without CUDA, and
  outside a checkout of the repository.
"""
import ast
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (Episode, RoundInputs, SimConfig,
                              generate_episode)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
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
                "kernels/budget_alloc.py"):
        assert mod in have, mod
    assert (ROOT / "src/repro_torch/kernels/csrc/budget_alloc.cu").is_file()


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
