"""Build and load the port's CUDA kernels (``nvcc`` + ``ctypes``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into ``<repo>/build/kernels``
(listed in ``.gitignore``). The library's file name carries a hash of the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited source
is rebuilt and a stale library is never loaded. Nothing here runs at import
time, and nothing falls back: a machine without ``nvcc`` or without a CUDA
device gets a ``RuntimeError``.

:func:`build_all` starts one ``nvcc`` per source at once and waits for
them; :func:`start_all` only starts them (the chip smoke script runs the
decode phases while the training kernels still compile), and
:func:`load` returns the loaded ``ctypes.CDLL``, waiting for its own
build where one is running.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Sources whose optimizer passes nvcc runs on every core
# (``--split-compile=0``): the two slowest, which bound ``build_all``'s
# time (``chip_smoke.py``'s [build] line), and whose ptxas report
# (registers, spills, shared memory) is the same with it. The decode
# sources build in a fraction of their time, and it moves their
# register allocation.
SPLIT_COMPILE = ("salo_table_attention", "salo_table_backward")


def _flags(name: str) -> tuple:
    """nvcc's flags for ``csrc/<name>.cu``."""
    return NVCC_FLAGS + (("--split-compile=0",) if name in SPLIT_COMPILE
                         else ())


_LIBS: Dict[str, ctypes.CDLL] = {}
# builds started by start_all and not waited for yet: name -> job
_PENDING: Dict[str, tuple] = {}


def sources() -> List[str]:
    """Names of the kernel sources in ``csrc/`` (without ``.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for root in cands:
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("the CUDA kernels need nvcc (CUDA_HOME, "
                           "/usr/local/cuda/bin or PATH); none was found")
    return found


def _lib_path(name: str) -> Path:
    # the hash covers the shared headers too, which any source may include
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    flags = " ".join(_flags(name)).encode()
    h = hashlib.sha256(src + flags).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is built; returns
    ``(final_path, tmp_path, Popen, start wall time)`` or ``None``. Its output
    goes to ``build/kernels/<name>.log`` (a file, not a pipe: a build no
    one waits for yet never blocks on a full pipe)."""
    out = _lib_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(BUILD_DIR / f"{name}.log", "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                text=True)
    return out, tmp, proc, time.time()


def _finish(name: str, job) -> str:
    out, tmp, proc, _ = job
    proc.wait()
    log = (BUILD_DIR / f"{name}.log").read_text()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)        # atomic: a concurrent loader never sees half
    return log


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device; "
                           "torch.cuda.is_available() is False")


def start_all() -> List[str]:
    """Start one nvcc for every source in ``csrc/`` whose library is not
    built, all at once, without waiting; returns their names. :func:`wait`
    (or :func:`load`) finishes each."""
    _require_cuda()
    for name in sources():
        if name not in _PENDING:
            job = _start(name)
            if job is not None:
                _PENDING[name] = job
    return list(_PENDING)


def wait(names=None) -> Dict[str, float]:
    """Wait for the started builds of ``names`` (all by default). Returns
    each one's build seconds, from nvcc's start to its library's write
    (0.0 where nothing was building)."""
    secs = {}
    for name in (sources() if names is None else names):
        job = _PENDING.pop(name, None)
        if job is not None:
            _finish(name, job)
        secs[name] = 0.0 if job is None else \
            job[0].stat().st_mtime - job[3]
    return secs


def build_all() -> Dict[str, float]:
    """Compile every source in ``csrc/`` in parallel (one nvcc each).
    Returns seconds spent per source (0.0 where the library was built)."""
    start_all()
    return wait()


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) of
    the last build of ``name`` in this checkout, or '' if none."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.is_file() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    _require_cuda()
    job = _PENDING.pop(name, None) or _start(name)
    if job is not None:
        _finish(name, job)
    lib = ctypes.CDLL(str(_lib_path(name)))
    _LIBS[name] = lib
    return lib
