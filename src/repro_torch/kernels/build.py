"""Build and load the Hopper kernels (``nvcc`` into a plain C library).

The kernels live in ``csrc/*.cu`` behind a C interface.  On first use the
source is compiled with ``nvcc`` for ``sm_90a`` into
``<repo>/build/repro_torch/``, under a name that carries a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is reused.  The library is loaded with ``ctypes``; every pointer and the
stream are passed as ``c_void_p``.

Never add ``--use_fast_math``: its approximate division and flushed
denormals break the kernels' bitwise contracts with their twins.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L, _Z = ctypes.c_longlong, ctypes.c_size_t
# Per library (csrc/<name>.cu): each entry point's C argument types and
# return type.  Launchers return a cudaError_t as int.
SIGNATURES = {
    "budget_alloc": {
        "ba_rowmax": ((_P, _P, _I, _I, _I, _P), _I),
        "ba_matvec": ((_P, _P, _P, _I, _I, _I, _I, _P), _I),
        "ba_matvec_t": ((_P, _P, _P, _I, _I, _I, _P), _I),
        "ba_dual_step": ((_P,) * 9 + (_I, _I, _F, _I, _P), _I),
        "ba_dual_ascent": ((_P,) * 9 + (_I, _I, _I, _F, _I, _F, _I, _I,
                                        _P), _I),
        "ba_dual_smem_limit": ((), _Z),
        "ba_dual_max_clusters": ((_I, _I), _I),
        "ba_boost_sweep": ((_P,) * 5 + (_I,) * 4 + (_F, _I, _I, _P), _I),
        "ba_boost_smem_limit": ((), _Z),
    },
    "dp_clip_noise": {
        "dp_rownorms": ((_P, _P, _P, _I, _L, _P), _I),
        "dp_clip_accumulate": ((_P, _P, _P, _I, _L, _P), _I),
        "dp_rownorms_chunk": ((), _I),
    },
    "attention": {
        "att_flash": ((_P,) * 4 + (_I,) * 7 + (_F, _P), _I),
        "att_decode": ((_P,) * 7 + (_I,) * 9 + (_F, _P), _I),
        "att_decode_residency": ((_I, _I), _I),
    },
    "rg_lru": {
        "rg_scan_at": ((_P,) * 4 + (_I,) * 4 + (_P,), _I),
        "rg_scan_bwd": ((_P,) * 7 + (_I,) * 3 + (_P,), _I),
    },
}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    if shutil.which("nvcc"):
        cands.append(Path(shutil.which("nvcc")))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the Hopper kernels "
                       "are compiled on the machine that runs them")


def build(name: str) -> tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless a library of the same source hash
    exists.  Returns ``(library path, build seconds, nvcc log)``; seconds
    is 0.0 and the log empty when the cached library was reused."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if out.is_file():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0, proc.stdout + proc.stderr


def build_all() -> dict[str, tuple[Path, float, str]]:
    """Build every library of :data:`SIGNATURES` at once, one ``nvcc`` per
    source, all started together; ``{name: build(name)}``."""
    with concurrent.futures.ThreadPoolExecutor(len(SIGNATURES)) as pool:
        futs = {name: pool.submit(build, name) for name in SIGNATURES}
        return {name: f.result() for name, f in futs.items()}


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library ``csrc/<name>.cu``, built on first use, with
    ``argtypes`` and ``restype`` declared for its own entry points."""
    path, _, _ = build(name)
    lib = ctypes.CDLL(str(path))
    for fn, (args, res) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(args)
        f.restype = res
    return lib
