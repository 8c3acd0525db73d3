"""Build, load and launch-check the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, and
loaded with ``ctypes``.  Nothing includes PyTorch's headers, so a build
takes seconds.  :func:`build` starts one ``nvcc`` per source, all at
once, and waits for them together.

Libraries land in ``build/repro_torch_kernels/`` at the repository root
(git-ignored), named by a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded.  A library is
written under a temporary name and renamed into place, so two processes
building at once cannot load a half-written file.

Every wrapper adds one to :data:`launch_counts` where it launches its
kernel, and nowhere else; a caller resets it to see which kernels a run
went through.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

SOURCES = ("uruv_search", "versioned_read", "uruv_range")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

launch_counts: "collections.Counter[str]" = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (looked on PATH and /usr/local/cuda/bin): the "
            "port's CUDA kernels are built from source on first use")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library among ``names`` in parallel.

    Returns the wall seconds each build took (0.0 for a library already
    built).  Raises with the compiler's output when any build fails.
    """
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    secs = {n: 0.0 for n in names}
    t0 = time.perf_counter()
    for n in names:
        out = _target(n)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    errors = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library ``name`` (built on first use), with the
    ``argtypes`` of every entry in ``signatures`` declared and ``restype``
    int (each C entry returns its launch's ``cudaGetLastError()``)."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise when a launch reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError {rc}")


def device_type(t) -> str:
    """``"cpu"`` (take the plain twin) or ``"cuda"`` (launch the kernel);
    any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain twin for device {t.device}")
    return t.device.type


def stream_ptr(t) -> int:
    """The current CUDA stream of ``t``'s device, as a C pointer value."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(kernel: str, device, dtype, **tensors) -> None:
    """Wrapper-side validation: every tensor of ``dtype``, on ``device``
    and contiguous."""
    for name, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, "
                             f"expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
