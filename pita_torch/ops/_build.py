"""Build the CUDA sources under ``pita_torch/csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch headers, so
``nvcc`` builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so csrc/<name>.cu

The library goes to ``pita_torch/_build/<hash>/`` (listed in .gitignore),
where the hash covers the source, the shared headers (``csrc/*.cuh``), the
flags and the compiler path, so an edited source or header builds anew. Building happens at first use, or all at once with
``build_all`` (one ``nvcc`` process per source, started together). Nothing is
built or loaded when the module is imported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("lj", "egnn_layer", "egnn_layer_tc", "egnn_layer_f32tc", "egnn_layer_bwd_f32tc",
           "egnn_tangent", "egnn_tangent_tc", "egnn_tangent_f32tc", "g_op")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str, nvcc: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode() + nvcc.encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def _start(name: str, nvcc: str):
    """Start nvcc for one source; None when the library is already built."""
    out = _lib_path(name, nvcc)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    text = log.decode(errors="replace")
    (out.parent / f"{name}.log").write_text(text)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{text}")
    os.replace(tmp, out)


def build_all() -> float:
    """Build every source in parallel; returns the wall seconds taken."""
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    jobs = {n: _start(n, nvcc) for n in SOURCES}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (register and shared-memory use, from -Xptxas -v)."""
    p = _lib_path(name, nvcc_path()).parent / f"{name}.log"
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        nvcc = nvcc_path()
        job = _start(name, nvcc)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(_lib_path(name, nvcc)))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on the cudaError_t a C entry point returned."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
