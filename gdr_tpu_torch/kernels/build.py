"""Builds the port's CUDA sources with ``nvcc`` at first use and loads them
with ``ctypes``.

Each ``gdr_tpu_torch/csrc/<name>.cu`` becomes one shared library with a
plain C interface, ``build/kernels/lib<name>-<hash>.so`` under the
repository root, keyed by a hash of the sources, the shared headers and
the flags — so a changed source rebuilds and an unchanged one loads at
once.  All missing libraries are compiled together, one ``nvcc`` process
per source.  A failed build or load raises; nothing falls back.

Only the repository's own sources are compiled; no CUTLASS or PyTorch
headers are included, which keeps a build at seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

# the element-type codes of the C interface (csrc/common.cuh, enum DType);
# int8 is only the int8 document store's rows
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
FLOAT_DTYPES = (torch.float32, torch.bfloat16)

CSRC =Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of the last build
build_logs: dict[str, str] = {}


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of gdr_tpu_torch are built from source at first use")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> float:
    """Compile every missing library, all ``nvcc`` processes at once.
    Returns the wall seconds spent; raises with the compiler's output on
    any failure."""
    names = sources() if names is None else names
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for n, out, tmp, p in procs:
        log, _ = p.communicate()
        build_logs[n] = log
        if p.returncode != 0:
            failed.append(f"--- {n}.cu (exit {p.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)
    elapsed = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return elapsed


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """Load ``lib<name>`` (building it first if needed) and declare its C
    functions: ``signatures`` maps a function name to its argument types.
    Every function returns a ``cudaError_t`` as an int."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.gdr_error_string.argtypes = [ctypes.c_int]
        lib.gdr_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.gdr_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")
