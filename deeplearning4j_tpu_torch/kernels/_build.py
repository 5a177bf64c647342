"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` on its own into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), and loaded with :mod:`ctypes`. Libraries land in ``_build/``
beside this package (listed in ``.gitignore``), named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is. Nothing here runs at import: the first call that needs
a kernel builds it, and :func:`build_all` builds every source at once, one
``nvcc`` process per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: compiler output (ptxas register/shared-memory report) per built source
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (not on PATH, nor under $CUDA_HOME/bin or "
        "/usr/local/cuda/bin): the port's CUDA kernels are built from "
        "source at first use")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; None when its library is current."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)        # atomic: a reader never sees half a file


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> List[str]:
    """Compile every ``csrc/*.cu`` that has no current library, all in
    parallel, and wait for them. Returns the names it compiled."""
    with _lock:
        started = {n: _start(n) for n in sources()}
        for n, s in started.items():
            if s is not None:
                _finish(n, s)
        return [n for n, s in started.items() if s is not None]


def bind(name: str, fn: str, argtypes, err: str):
    """(``fn`` of ``csrc/<name>.cu``'s library with its ``argtypes`` and an
    int result, its error-string function ``err``), the library built first
    if needed."""
    lib = load(name)
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    e = getattr(lib, err)
    e.argtypes = [ctypes.c_int]
    e.restype = ctypes.c_char_p
    return f, e


def call(name: str, kernel, args, device) -> None:
    """Launch ``kernel`` = (function, error-string function), as
    :func:`bind` gives it, with ``args`` and the current stream of
    ``device``; raises RuntimeError when the launch failed."""
    import torch
    fn, err_str = kernel
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        what = (f"CUresult {-err}" if err < 0 else f"CUDA error {err}")
        raise RuntimeError(f"{name} launch failed: {what} "
                           f"({err_str(err).decode()})")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            started = _start(name)
            if started is not None:
                _finish(name, started)
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
    return lib
