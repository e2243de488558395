"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded through ``ctypes``
(no PyTorch headers, so a build takes seconds).  Libraries go to
``<repo>/build/torch_kernels/`` (override: ``REPRO_TORCH_BUILD_DIR``),
named by a hash of the source, the headers beside it (``*.cuh``) and
the flags, so a changed source rebuilds and an unchanged one loads what
is there.  The flags never
include ``--use_fast_math``: the compute-path kernels (mixbench,
fma_matmul) rely on the exact instruction each intrinsic names.  :func:`build_all`
starts one ``nvcc`` per source, all together, and waits for them.

Nothing here runs at import: the CPU tests import every module, and
this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["KernelBuildError", "KernelLaunchError", "LaunchCounter",
           "bind", "build_all", "load", "SOURCES"]

_PKG = Path(__file__).resolve().parents[1]          # src/repro_torch
CSRC = _PKG / "csrc"
SOURCES = ("decode_attention_paged", "decode_attention_dense",
           "flash_attention", "mixbench", "fma_matmul", "qmatmul",
           "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[tuple, ctypes._CFuncPtr] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error code."""


class LaunchCounter:
    """Plain count of kernel launches; a wrapper adds one where it
    launches its kernel and nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0

    def reset(self) -> None:
        self.n = 0


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else _PKG.parents[1] / "build" / "torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError("nvcc not found (PATH or /usr/local/cuda/bin)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # what a source includes
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> Dict[str, str]:
    """Compile every library not already built, one ``nvcc`` process per
    source, all started together.  Returns {name: ptxas report}."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs: List[tuple] = []
    reports: Dict[str, str] = {}
    for name in names:
        lib = _lib_path(name)
        log = lib.with_suffix(".log")
        if lib.exists():
            reports[name] = log.read_text() if log.exists() else ""
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp, log,
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, lib, tmp, log, proc in procs:
        text, _ = proc.communicate()
        log.write_text(text)
        reports[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}:\n{text}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def bind(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of ``csrc/<name>.cu``'s library with its argument types
    set and an int result (the launch's ``cudaError_t``), bound once:
    a wrapper that sets ``argtypes`` on every call pays for it on every
    launch."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[name, symbol] = fn
    return fn

