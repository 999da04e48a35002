"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source ``repro_torch/csrc/<name>.cu`` exposes a plain C launcher and
is compiled for Hopper (``sm_90a``) into its own shared library under
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``).
A wrapper module may name preprocessor definitions in
``NVCC_DEFINES`` (the limits its plan cuts calls to), which its source is
compiled with.  The library's file name carries a digest of its source,
the shared headers and the flags, so an edited kernel is rebuilt and a
built one is reused.  Nothing is built when the
package is imported: a wrapper asks for its library at its first launch,
and :func:`build_all` compiles every source at once, one ``nvcc`` process
each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("quant_matmul", "decode_attention", "flash_attention",
           "flash_attention_bwd", "ssd_scan")
# The wrapper module of a source whose name is not its own.
_MODULES = {"flash_attention_bwd": "flash_attention"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def flags(name: str) -> Tuple[str, ...]:
    """nvcc's flags for source ``name``: the common ones, then the
    ``-D`` definitions its wrapper module declares in ``NVCC_DEFINES``."""
    mod = importlib.import_module(
        f"repro_torch.kernels.{_MODULES.get(name, name)}")
    return NVCC_FLAGS + tuple(
        f"-D{k}={v}" for k, v in getattr(mod, "NVCC_DEFINES", {}).items())


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(flags(name)).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> Tuple[Path, Path, subprocess.Popen]:
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp: Path,
            proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str] = KERNELS) -> float:
    """Compile every listed kernel that is not built yet, all ``nvcc``
    processes in parallel, and load them.  Returns the wall seconds."""
    t0 = time.perf_counter()
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = [(n, *_start(n)) for n in names
                if n not in _libs and not _target(n).exists()]
        errors = []
        for name, out, tmp, proc in jobs:
            try:
                _finish(name, out, tmp, proc)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        for n in names:
            if n not in _libs:
                _libs[n] = ctypes.CDLL(str(_target(n)))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = _libs[name]
    return lib


def launcher(name: str, argtypes, symbol: str = "") -> ctypes._CFuncPtr:
    """The C launcher ``symbol`` (by default ``<name>_launch``) of kernel
    source ``name`` (built on first use), typed: pointers and the stream
    as ``c_void_p`` (a bare Python int would be cut to 32 bits), the CUDA
    error code as the result."""
    fn = getattr(library(name), symbol or f"{name}_launch")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def stream_ptr(device) -> int:
    """The handle of PyTorch's current stream on ``device``: the kernels
    launch there, in order with the surrounding PyTorch work."""
    return torch.cuda.current_stream(device).cuda_stream


def refuse_grad(name: str, item: str, *tensors) -> None:
    """Raise if a CUDA input of kernel ``name`` requires grad under grad
    mode: the kernel has no backward, and its output would carry no
    ``grad_fn`` (every gradient below it silently lost).  ``item`` names
    the ROADMAP item that brings, or rules out, the backward."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: no backward kernel on the card ({item}); call it "
            "under torch.no_grad() or with inputs that do not require grad")


def check_launch(name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
